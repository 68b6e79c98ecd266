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
6. (run after phase 7, and its ``segment_gather`` row right after the
   gather window, so that neither the recorded calls nor the gather
   inputs stay on the card into phases 9-11) each engine kernel's wrapper
   on the largest inputs the main path gave it (phases 4-5c), and the
   kernels of ``SMALLEST`` also on the smallest,
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
   512-256-1, hotness 8; 1,223,392,321 parameters) for 2 steps at the
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
   same weights: the loss trajectories agree;
10. lm (after phase 9, whose model and optimizer state are freed first):
   (a) ``repro_torch.launch.train.main`` trains qwen2-1.5b at its
   published size (28 layers, d_model 1536, GQA 12/2, d_ff 8960, vocab
   151,936, QKV bias, untied head; 1,777,088,000 parameters) for 2 steps
   at ``train_4k``'s sequence length of 4096, the batch cut from 256 to 4
   (AdamW's float32 state alone is 28.4 GB) in 2 microbatches, and writes
   its 21.3 GB final checkpoint (the phase first checks that 50 GB are
   free under ``build/``); ``final step=3`` is printed, the loss is finite,
   every leaf moved, and the checkpoint's step and a leaf are read back,
   then it is removed; one step is split into H2D, forward + backward and
   AdamW (CUDA events), one runs under ``torch.profiler`` (the busy
   share), and the step's model FLOPs are set against the card's dense
   bf16 peak; (c) on (a)'s weights ``long_500k`` (batch 1, a 15.0 GB cache
   filled from a seed, ``pos`` = 524288 - 4, 4 steps) and ``prefill_32k``
   (``forward`` without gradients at batch 1 and the longest multiple of
   4096 up to 32768 whose plain attention fits: one layer's float32
   logits take 12 · S² · 4 B, 51.5 GB at 32768; the length is chosen from
   the forward's peak memory at three shorter lengths); qwen3-8b at its
   published size (36 layers, 8.19B parameters, 32.8 GB in float32) from
   seeded weights: a 32-token prompt fed token by token through
   ``decode_step`` equals ``forward`` at every position within
   ``LM_DECODE_TOL`` (float32 and bfloat16 compute), then ``decode_32k``
   (batch cut from 128 to 4: the cache at 128 lanes would take 618 GB; a
   19.3 GB cache filled from a seed, ``pos`` = 32768 - 8, 8 steps); each
   decode step is timed with CUDA events beside its bound (the float32
   weights and the cache read once); (b) qwen3-8b (qk_norm) and
   minitron-8b (vocab 256,000, theta 1e4) at full width and depth 2, batch
   2 x 128, from the same weights on the card and (float32) on the CPU:
   the loss, the gradient norm, each gradient leaf norm-wise and one AdamW
   step (the card's, against the step from the CPU's gradients, both
   taken on the card) within the ``LM_*`` tolerances; in bfloat16 compute
   each gradient leaf on the card against a float64 run on the card (the
   truth both sides are measured against), with a second card run (the
   card's own spread) recorded beside them.  Cuts: depth (steps, (b)'s
   layers), batch ((a) 4, ``decode_32k`` 4), the prefill length and (b)'s
   bfloat16 CPU run (``LM_B_CPU_DTYPES``), each for the reason given;
   widths are the published ones;
11. moe (after phase 10, whose models are freed first): (a)
   deepseek-v2-236b at its published widths (MLA with q_lora 1536,
   kv_lora 512, 128 heads; 160 routed experts top-6 and 2 shared, d_ff
   1536; vocab 102,400), depth cut from 60 to 2 (its dense first layer
   and one MoE layer; 5,358,649,344 parameters, 21.4 GB in float32: the
   whole model would be 943 GB), from seeded weights: a 32-token prompt at
   batch 2 fed token by token through ``decode_step`` (the absorbed MLA
   cache) equals ``forward`` at every position within ``MOE_DECODE_TOL``
   in float32 and bfloat16 compute, run with capacity_factor = E / k (26.7)
   so that no token can be dropped, as the reference's own
   ``test_mla_decode_matches_forward`` raises it (a decode step routes B
   tokens, the forward B·S, so at the published 1.25 they drop different
   ones); then at the published capacity ``decode_32k`` at its published
   batch of 128 (a 9.66 GB cache filled from a seed, ``pos`` = 32768 - 8,
   8 steps, each timed beside its bound, and the share of (token, expert)
   assignments one more step drops at capacity 6), ``long_500k`` (batch
   1, a 1.21 GB cache, 4 steps) and ``prefill_32k`` at batch 1 and the
   longest multiple of 4096 whose plain attention fits (one layer's
   float32 logits take 128 · S² · 4 B, 34.4 GB at 8192); the cache holds
   1,152 B a token and layer against 81,920 B for a full 128-head K/V;
   (c) dbrx-132b at its published widths, depth cut from 40 to 2
   (7,751,270,400 parameters, 31.0 GB): decode against forward as in (a)
   (capacity_factor 4), ``decode_32k`` at the largest batch that fits
   (at 128 its GQA cache alone is 34.4 GB, and each step widens a layer's
   keys to float32) and prefill as in (a) (48 · S² · 4 B a layer); (d)
   ``launch.train.main`` trains each arch's smoke preset for 3 steps on
   the card: ``final step=3``, finite losses, every leaf moved, the
   routers included; (b) DeepSeek at depth 2 and DBRX at depth 1 (at 2 its
   weights, two gradient sets and the saved bf16 casts come to about 81
   GB), batch 2 x 64, card against CPU in float32: the loss with aux, the
   gradient norm and each gradient leaf norm-wise within the ``MOE_*``
   tolerances, in bfloat16 each gradient leaf against the float64 run,
   two card runs equal bit for bit in float32 and bfloat16 (the MoE
   dispatch and combine are deterministic), beside a float64 run on the
   card taken in passes (DeepSeek's float64 weights and gradients
   at once would take 86 GB).  Cuts: depth ((a), (c) 2; (b) 2 and 1),
   DBRX's ``decode_32k`` batch, both prefill lengths and (b)'s bfloat16
   CPU run (``MOE_B_CPU_DTYPES``), each for the reason given; widths are
   the published ones;
12. gnn (after phase 11): (a) ``repro_torch.launch.train.main`` trains
   PNA at its published widths (4 layers, hidden 75, 4 aggregators × 3
   scalers, d_feat 1433, 16 classes; 667,666 parameters) for 20 steps on
   the sampled stream on the card, every loss finite, and the first three
   steps of the same schedule run twice on the CPU from the seed's
   weights, the card's losses there within 1e-4 (the later steps are
   chaotic: ``GNN_A_*``); (b) PNA,
   MeshGraphNet (15 layers, hidden 128, LayerNorm MLPs) and DimeNet (6
   blocks, hidden 128, 8 bilinear, 7 × 6 basis) at their published widths
   on the ``GNN_SHAPES`` cells whose step fits one card (``minibatch_lg``
   for all three, ``molecule`` for MeshGraphNet and DimeNet,
   ``full_graph_sm`` for PNA and MeshGraphNet), a batch drawn from a seed
   at the cell's shapes (DimeNet's ``t = 8e`` triplets): one step on the
   card split into H2D, forward, backward and AdamW (CUDA events; then
   three warm passes of each, their median and range), its peak memory,
   the same step on
   the CPU from the same weights and a float64 run on the card: the loss,
   the gradient norm, each gradient leaf norm-wise and the AdamW step
   within ``GNN_TOL`` / ``GNN_ADAM_RTOL`` (at DimeNet's ``minibatch_lg``,
   whose CPU step took 70 s, the card against the float64 run: cut on the
   CPU side only, ``GNN_CARD_ONLY``), the card's own spread (a second
   run: its scatter-adds are float atomics) beside them; (c)
   ``ogb_products``: each
   arch's cut, a tensor its step must form against the card's free
   memory;
13. sharded training (after phase 12): (a) one NCCL rank, mesh (data,
   model) = (1, 1): the explicit-SPMD step (``sharding.gnn_spmd``) of
   GCN at ``full_graph_sm`` and of PNA, MeshGraphNet, DimeNet and
   DimeNet's edge-sharded v2 at ``minibatch_lg``, published widths,
   against the unsharded step on the card from the same weights (both
   with torch's deterministic algorithms): the loss, every gradient leaf
   and one AdamW step within the reference's SPMD limits (``ST_*``), the
   collectives counted with ``torch.profiler``, each step's peak and its
   time (cold, then the median and range of ``ST_WARM`` warm passes,
   plain and SPMD in turn); (c) qwen2-1.5b at depth 2 and phase 10's 4 x
   4096: the DP+TP step (``sharding.lm``, DTensor parameters, moments and
   batch) and ``pipelined_loss`` with one stage and 2 microbatches, each
   against the plain step on the card (the loss, every gradient leaf, the
   AdamW update by norm) and timed as (a); (b) after (a) and (c) have
   run alone, two gloo ranks sharing the card, mesh (1, 2): the same five
   at ``molecule``, each rank against the unsharded step (it verifies
   nothing multi-card; no DP+TP step there: ``ST_B_NO_LM``);
14. dryrun (after phase 13): (a) the engine cells of
   ``configs/turbohom.py`` at their production size on one card: a graph
   of 260,000,000 vertices and 1,230,000,000 edges in 18 edge-label
   blocks built on the card from ``EC_SEED`` (``engine_graph``: the join's
   label is the last block, so every join probe searches past offset
   2^30; rows 2 and 3 copy half their edges from row 0's, which makes the
   closing edges), one rank's replica of it (9.08 GB for ``triangle_q2``,
   10.12 GB for ``star_q4``), 16 x 16,384 start vertices dealt by
   ``GreedyChunker``; every shard's row through ``engine_cell`` on a
   one-rank NCCL mesh (the ``engine_cell`` window), each shard's count and
   overflow equal to the port's CPU run on a host copy; one shard's
   ``bitmap_superset`` and ``edge_exists`` calls bit-equal to their plain
   versions on the card, the join also equal to numpy's ``searchsorted``
   in int64, both answers of each kernel seen; five warm passes a shard;
   the heaviest row-0 vertices at capacity 4096 overflow on the card and
   on the CPU; (b) ``repro_torch.launch.dryrun`` in a subprocess on
   ``DRYRUN_CELLS`` (single-pod mesh of 256 fake ranks, fake tensors on
   ``cuda``): every record ``ok``, no kernel launched, no device memory
   allocated.

The run drives twelve paths, each in its own launch-counting window: the
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
model build and final checkpoint; 78 ``segment_gather`` launches) and the
lm path (phase 10 (a): ``launch.train.main``'s three qwen2-1.5b steps, its
model build and final checkpoint; the reference's LM reaches no Pallas
kernel, so this window expects none of the seven), and the moe path
(phase 11 (a), (c) and (d): the forward and decode calls and the smoke
presets' training; the reference's MoE and MLA are plain ``jnp`` too, so
none of the seven), and the gnn path (phase 12 (a) and (b)'s card
steps; the reference's PNA, MeshGraphNet and DimeNet aggregate with
``jax.ops.segment_*`` outside any Pallas kernel, so none of the seven),
and the sharded_train path (phase 13, all of it; plain torch and
collectives, none of the seven), and the engine_cell path (phase 14 (a):
each engine cell's step on every shard once; ``bitmap_superset`` and
``edge_exists``).
The device memory still allocated before phases 9-12 is logged and
recorded (``held`` and each phase's
``held_before_phase``).  The
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
import contextlib
import json
import logging
import os
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
    # phase 10: the reference's LM is plain jnp (einsum attention, x @ w
    # products): no Pallas kernel, so none of the seven
    "lm": (),
    # phase 11: the reference's MoE and MLA are plain jnp too (einsums,
    # argsort, searchsorted, scatters), so none of the seven
    "moe": (),
    # phase 12: PNA, MeshGraphNet and DimeNet aggregate with
    # jax.ops.segment_* outside any Pallas kernel: none of the seven
    "gnn": (),
    # phase 13: the same models' SPMD steps and the LM's DP+TP step and
    # pipeline, all plain torch and collectives: none of the seven
    "sharded_train": (),
    # phase 14 (a): the engine cells' steps, their label filter and join
    "engine_cell": ("edge_exists", "bitmap_superset"),
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


def kernel_table(torch, ops, ref, rec: Recorder) -> list:
    """Phase 6: each engine kernel at the main path's largest shapes (the
    recorded calls of the static, params and live windows).  The rows'
    launch counts are filled in at the end (``fill_launches``)."""
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
               "replaces": replaces, "library_ms": None,
               **timed_call(name, rows, args, kw)}
        if name in SMALLEST:
            row["smallest"] = timed_call(name, *rec.smallest[name])
            row["launch_floor_ms"] = floor
        table.append(row)
    return table


def fill_launches(table: list, by_path: dict[str, dict]) -> None:
    """Each row's launches: the sum over the windows, and each window's
    count (host dicts read after each window)."""
    for row in table:
        name = row["name"]
        row["launches"] = sum(int(c[name]) for c in by_path.values())
        row["launches_by_path"] = {p: int(c[name])
                                   for p, c in by_path.items()}


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


def gather_row(torch, ops, ref, inputs, outs) -> dict:
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
        "replaces": replaces, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
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
ZOO_STEPS = 2  # cut from 3 for the script's time limit
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
    for 2 steps at batch 65,536, then writes its final checkpoint; the
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


# ------------------------------------------------------------- phase 10: lm

# (a): the dense LM trainer at qwen2-1.5b's published size (configs/
# qwen2_1p5b.py), train_4k's sequence length; the batch cut from 256 to 4
# (AdamW's float32 moments alone take 14.2 GB, with the weights and the
# gradients 28.4 GB), in 2 microbatches; the final checkpoint is about
# 21.3 GB
LM_ARCH = "qwen2-1.5b"
LM_PARAMS = 1_777_088_000
LM_BATCH = 4
LM_SEQ = 4096
LM_MICROBATCHES = 2
LM_STEPS = 2  # cut from 3 for the script's time limit
LM_FREE_BYTES = 50e9
# (b): full width, depth cut to 2 layers, batch 2 x 128 (TokenStream seed
# 0), card against CPU in float32 and bfloat16, beside a float64 run on the
# card (the truth both are held to in the record)
LM_B_ARCHS = ("qwen3-8b", "minitron-8b")
LM_B_LAYERS = 2
LM_B_BATCH = 2
LM_B_SEQ = 128
# the dtypes whose gradients also run on the CPU: the bfloat16 CPU run
# (17.6 s qwen3-8b, 24.1 s minitron-8b on the H100's host; a shorter
# sequence saves nothing, the weights' size sets it) is cut for the
# script's time limit, as phase 11 (b)'s.  In bfloat16 the card's
# gradients are held to the float64 run's instead, each leaf within
# LM_GRAD_RTOL (set from both devices' distances to float64, the card's
# alone 2.3e-2)
LM_B_CPU_DTYPES = ("float32",)
# (c): decode at qwen3-8b's published size against its forward (a
# 32-token prompt, batch 2), decode_32k (batch cut from 128 to 4: the cache
# at 128 lanes would take 618 GB) and long_500k on (a)'s weights; prefill
# at batch 1, the longest sequence up to 32768 whose plain attention fits
LM_DECODE_ARCH = "qwen3-8b"
LM_PROMPT = 32
LM_DECODE_32K = (4, 32768, 8)  # batch, cache length, steps
LM_LONG_500K = (1, 524288, 4)
LM_PREFILL_MAX = 32768
LM_PREFILL_STEP = 4096
LM_PREFILL_PROBES = (2048, 4096, 8192)
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_S = 989e12
# (b)'s tolerances, card against CPU, from the first chip run of this phase
# (H100, PERF.md §6): the card is deterministic here (two runs equal
# bit for bit), and each device's gradients lie from the float64 run's by
# up to 5.9e-6 (card) and 2.0e-6 (CPU) norm-wise a leaf in float32, 2.3e-2
# and 2.1e-2 in bfloat16, so two runs can differ by the sum: a leaf within
# 3e-5 (float32) and 5e-2 (bfloat16) norm-wise (measured 6.0e-6, 1.2e-2).
# The loss: within 1e-6 and 1e-4 (measured 7.6e-8, 9.5e-6); the gradient
# norm within 1e-5 and 1e-3 (measured 0, 1.1e-4).  One AdamW step moves an
# element by about lr·sign(g), so an element whose gradient the two devices
# round to either side of 0 moves 2·lr apart: each leaf's new weights
# within 3e-3 (float32) and 0.5 (bfloat16: the qk-norm gains' gradients
# cancel to rounding level) of its update's norm (measured 3.9e-4, 0.18);
# a wrong step (a missing bias correction, the wrong rate) misses by 1 or
# more
LM_LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-4}
LM_GNORM_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
LM_GRAD_RTOL = {"float32": 3e-5, "bfloat16": 5e-2}
LM_ADAM_RTOL = {"float32": 3e-3, "bfloat16": 0.5}
# (c): decode against forward, the largest difference of a position's
# logits over the forward's largest |logit|: GEMMs of 1 row and of 32 rows
# sum in other orders over 36 layers (measured 3.3e-6 in float32, 2.0e-2 in
# bfloat16; the reference's own smoke test allows 0.15 absolute in bf16)
LM_DECODE_TOL = {"float32": 5e-5, "bfloat16": 0.1}


def lm_model(torch, name: str, cfg, device, state=None, seed: int = 1):
    """The LM of ``name`` at ``cfg`` on ``device``: weights from ``state``
    (a state dict) or drawn from ``seed``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import model_for

    arch = get_arch(name)
    if state is None:
        return model_for(arch, cfg, device,
                         torch.Generator(device=device).manual_seed(seed))
    model = model_for(arch, cfg, "meta", None)
    model.load_state_dict({k: v.to(device, copy=True)
                           for k, v in state.items()}, assign=True)
    return model


def lm_grads(torch, model, batch) -> tuple[float, dict]:
    """The loss and each gradient leaf of ``model`` on ``batch``."""
    from repro_torch.models import transformer
    from repro_torch.train.trainstep import batch_to, value_and_grad

    dev = next(model.parameters()).device
    loss, grads = value_and_grad(transformer.loss_fn, model,
                                 batch_to(batch, dev))
    return float(loss), grads


# elements a step of lm_rel / moe_digest: a 5 GB leaf then needs no 15 GB
# of temporaries
CHUNK = 1 << 26


def lm_rel(torch, a, b) -> float:
    """||a - b|| / ||b|| on ``a``'s device, ``b`` brought over a chunk at a
    time and the squares summed in float64."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for lo in range(0, a.numel(), CHUNK):
        x = a[lo:lo + CHUNK].double()
        y = b[lo:lo + CHUNK].to(a.device, torch.float64)
        num += float(torch.sum((x - y) ** 2))
        den += float(torch.sum(y * y))
    return (num / max(den, 1e-300)) ** 0.5


def lm_card_vs_cpu(torch, name: str) -> dict:
    """(b) for one arch: at full width and ``LM_B_LAYERS`` layers, one
    float64 run on the card, then in float32 and bfloat16 two runs on the
    card (its spread) from the same weights and, in the dtypes of
    ``LM_B_CPU_DTYPES``, one on the CPU and one AdamW step from a fresh
    state from the card's gradients and one from the CPU's, both on the
    card.  Returns per dtype the losses, gradient norms, and per leaf the
    norm-wise gaps card-card and card-float64 (and card-CPU and
    CPU-float64) of the gradients, and of the two steps' weights over the
    CPU gradients' update (the largest of each).  The comparisons run on
    the card, each host tensor crossing once."""
    import dataclasses

    from torch.linalg import vector_norm

    from repro_torch.configs import get_arch
    from repro_torch.train.data import TokenStream
    from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                             adamw_update, global_norm)
    from repro_torch.train.trainstep import named_params

    arch = get_arch(name)
    base = dataclasses.replace(arch.config, n_layers=LM_B_LAYERS)
    batch = TokenStream(vocab=base.vocab, batch=LM_B_BATCH, seq=LM_B_SEQ,
                        seed=0).batch_at(0)
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=LM_STEPS)
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    card = lm_model(torch, name, base, "cuda")
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in card.state_dict().items()}
    # the truth: the same weights in float64, compute and logits too, on
    # the card (converted in place, so the card never holds both models)
    card.double()
    card.cfg = dataclasses.replace(base, compute_dtype="float64",
                                   attn_fp32_logits=False)
    l64, g64 = lm_grads(torch, card, batch)
    gn64 = float(global_norm(g64))
    truth = {k: g64.pop(k).cpu().float() for k in list(g64)}
    del card
    card = lm_model(torch, name, base, "cuda", state=state)
    cpu = lm_model(torch, name, base, "cpu", state=state)
    params = named_params(card)
    out = {"params": sum(v.numel() for v in state.values()),
           "card_bytes_before": held,
           "float64": {"loss": l64, "grad_norm": gn64}}
    for dt in ("float32", "bfloat16"):
        card.cfg = cpu.cfg = dataclasses.replace(base, compute_dtype=dt)
        t_g = time.perf_counter()
        l_c, g_c = lm_grads(torch, card, batch)
        l_c2, g_c2 = lm_grads(torch, card, batch)
        leaves = {k: {"card_card": lm_rel(torch, g_c2[k], g),
                      "card_f64": lm_rel(torch, g, truth[k])}
                  for k, g in g_c.items()}
        del g_c2
        row = {"loss_card_again": l_c2, "leaves": leaves}
        if dt not in LM_B_CPU_DTYPES:
            row.update(loss=[l_c, None],
                       grad_norm=[float(global_norm(g_c)), None],
                       cpu_s=time.perf_counter() - t_g)
            row["worst"] = {f: max((v[f], k) for k, v in leaves.items())
                            for f in ("card_card", "card_f64")}
            out[dt] = row
            del g_c
            continue
        t_h = time.perf_counter()
        l_h, g_h = lm_grads(torch, cpu, batch)
        gn_h = float(global_norm(g_h))
        row["cpu_grads_s"] = time.perf_counter() - t_h
        g_hc = {}
        for k in list(g_h):
            g, t = g_h.pop(k).to("cuda"), truth[k].to("cuda")
            leaves[k].update(card_cpu=lm_rel(torch, g_c[k], g),
                             cpu_f64=lm_rel(torch, g, t))
            g_hc[k] = g
        del g, t
        gn_c = float(global_norm(g_c))
        # the CPU gradients' AdamW step, taken on the card (on the CPU an
        # eager AdamW over these 6.6-10.5 GB of float32 leaves took 25-46 s
        # a call, 143 s of the phase: the script's first cut, PERF.md §7),
        # then the card gradients' step from the same weights
        t_a = time.perf_counter()
        adamw_update(params, g_hc, adamw_init(params, opt_cfg), opt_cfg)
        del g_hc
        got_h = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state[k])
        row["cpu_grads_adamw_s"] = time.perf_counter() - t_a
        adamw_update(params, g_c, adamw_init(params, opt_cfg), opt_cfg)
        del g_c
        with torch.no_grad():
            for k, p in params.items():
                start, want = state[k].to("cuda"), got_h.pop(k).to("cuda")
                leaves[k]["adam_card_cpu"] = float(
                    vector_norm(p - want, dtype=torch.float64)
                    / vector_norm(want - start, dtype=torch.float64)
                    .clamp(min=1e-300))
                # back to the weights both start from
                p.copy_(start)
        del start, want
        row.update(loss=[l_c, l_h], grad_norm=[gn_c, gn_h],
                   cpu_s=time.perf_counter() - t_g)
        row["worst"] = {f: max((v[f], k) for k, v in leaves.items())
                        for f in ("card_cpu", "card_card", "card_f64",
                                  "cpu_f64", "adam_card_cpu")}
        out[dt] = row
    del card, cpu, params, state, truth
    out["seconds"] = time.perf_counter() - t0
    return out


def lm_check_b(name: str, got: dict) -> None:
    """(b)'s checks: loss, gradient norm, each gradient leaf norm-wise and
    the AdamW step's weights, card against CPU, within ``LM_*``; in a
    dtype without a CPU run (``LM_B_CPU_DTYPES``) each gradient leaf
    against the float64 run's."""
    for dt in ("float32", "bfloat16"):
        row = got[dt]
        if dt not in LM_B_CPU_DTYPES:
            for k, v in row["leaves"].items():
                check(v["card_f64"] <= LM_GRAD_RTOL[dt],
                      f"phase 10 (b) {name} {dt}: gradient {k} differs from "
                      f"the float64 run's: {v}")
            continue
        (l_c, l_h), (g_c, g_h) = row["loss"], row["grad_norm"]
        check(abs(l_c - l_h) <= LM_LOSS_RTOL[dt] * abs(l_h),
              f"phase 10 (b) {name} {dt}: loss {l_c} on the card, {l_h} on "
              f"the CPU")
        check(abs(g_c - g_h) <= LM_GNORM_RTOL[dt] * abs(g_h),
              f"phase 10 (b) {name} {dt}: gradient norm {g_c} on the card, "
              f"{g_h} on the CPU")
        for k, v in row["leaves"].items():
            check(v["card_cpu"] <= LM_GRAD_RTOL[dt],
                  f"phase 10 (b) {name} {dt}: gradient {k} differs from the "
                  f"CPU's: {v}")
            check(v["adam_card_cpu"] <= LM_ADAM_RTOL[dt],
                  f"phase 10 (b) {name} {dt}: the AdamW step of {k} differs "
                  f"from the CPU's: {v}")


def lm_decode_vs_forward(torch, model, tokens) -> dict:
    """(c): ``forward`` on ``tokens`` against ``decode_step`` fed them one
    at a time into a fresh cache, in float32 and in bfloat16 on the same
    weights: per dtype the largest difference of a position's logits over
    the forward's largest |logit|, and the decode's ms a step."""
    import dataclasses

    from repro_torch.models import transformer

    out = {}
    cfg0 = model.cfg
    for dt in ("float32", "bfloat16"):
        model.cfg = dataclasses.replace(cfg0, compute_dtype=dt)
        with torch.no_grad():
            full, _ = transformer.forward(model, tokens)
        cache = transformer.init_cache(model.cfg, tokens.shape[0],
                                       tokens.shape[1], device="cuda")
        steps, times = [], []
        for t in range(tokens.shape[1]):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, cache = transformer.decode_step(model, cache,
                                                    tokens[:, t:t + 1])
            ev[1].record()
            steps.append(logits[:, 0])
            times.append(ev)
        dec = torch.stack(steps, 1).float()
        full = full.float()
        torch.cuda.synchronize()
        scale = float(full.abs().max())
        out[dt] = {"max_abs_of_max": float((dec - full).abs().max()) / scale,
                   "per_position": [float((dec[:, t] - full[:, t]).abs().max())
                                    / scale for t in range(full.shape[1])],
                   "norm_rel": lm_rel(torch, dec, full),
                   "logit_max": scale,
                   "ms_per_step": [a.elapsed_time(z) for a, z in times]}
        del full, dec, cache
    model.cfg = cfg0
    return out


def lm_decode_cell(torch, model, batch: int, length: int, steps: int,
                   seed: int, what: str = "phase 10 (c)",
                   after=None) -> dict:
    """A decode cell: a cache of ``length`` filled from ``seed`` (N(0, 1)
    keys and values, or MLA's c_kv and RoPE keys), ``pos`` = length -
    steps, then ``steps`` decode steps of one token a sequence, each timed
    with CUDA events; the logits must be finite and ``pos`` must reach
    ``length``.  The bound is the bytes a step must read, the float32
    weights and the whole cache, over the card's memory rate.  ``after``,
    if given, is called with the model, the full cache and one more batch
    of tokens once the timed steps are done; its result goes under
    ``after``."""
    from repro_torch.models import transformer

    cfg = model.cfg
    cache = transformer.init_cache(cfg, batch, length, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    entries = [k for k in cache if k != "pos"]
    for k in entries:
        cache[k].normal_(generator=gen)
    cache["pos"].fill_(length - steps)
    tokens = torch.randint(0, cfg.vocab, (steps + 1, batch, 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    cache_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in entries)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    times = []
    for i in range(steps):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        logits, cache = transformer.decode_step(model, cache, tokens[i])
        ev[1].record()
        times.append(ev)
        check(bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (batch, 1, cfg.vocab),
              f"{what}: decode step {i} at cache {length} gave "
              f"logits {tuple(logits.shape)}, not all finite")
    torch.cuda.synchronize()
    check(int(cache["pos"]) == length,
          f"{what}: pos {int(cache['pos'])} after {steps} steps, not "
          f"{length}")
    ms = [a.elapsed_time(z) for a, z in times]
    out = {"batch": batch, "cache_len": length, "steps": steps,
           "cache_bytes": cache_bytes, "weight_bytes": weight_bytes,
           "ms_per_step": ms,
           "bound_ms": (cache_bytes + weight_bytes) / PEAK_BYTES_S * 1e3}
    if after is not None:
        out["after"] = after(model, cache, tokens[steps])
    del cache
    return out


def lm_prefill(torch, model, probes=LM_PREFILL_PROBES,
               what: str = "phase 10 (c)") -> dict:
    """``prefill_32k`` at batch 1: the forward's peak memory at ``probes``
    lengths, fitted as a + b·S + c·S², picks the longest multiple of
    ``LM_PREFILL_STEP`` up to ``LM_PREFILL_MAX`` that fits in 90% of the
    free device memory; that forward is timed (no gradients) and its
    logits must be finite."""
    from repro_torch.models import transformer

    def peak(s: int) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tok = torch.zeros((1, s), dtype=torch.int32, device="cuda")
        with torch.no_grad():
            logits, _ = transformer.forward(model, tok)
        del logits
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    xs = np.array(probes, np.float64)
    ys = np.array([peak(int(s)) for s in xs], np.float64)
    c, b, a = np.polyfit(xs, ys, 2)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fits = [s for s in range(LM_PREFILL_STEP, LM_PREFILL_MAX + 1,
                             LM_PREFILL_STEP)
            if a + b * s + c * s * s <= 0.9 * free]
    check(bool(fits), f"{what}: no prefill length fits {free} B")
    s = fits[-1]
    tok = torch.randint(0, model.cfg.vocab, (1, s), device="cuda",
                        dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    with torch.no_grad():
        logits, _ = transformer.forward(model, tok)
    ev[1].record()
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(logits).all())
    check(ok and tuple(logits.shape) == (1, s, model.cfg.vocab),
          f"{what}: prefill at {s} gave logits {tuple(logits.shape)}")
    del logits
    cfg = model.cfg
    return {"seq": s, "probe_peaks": dict(zip(probes, ys.tolist())),
            "fit_bytes_at_32768": a + b * 32768 + c * 32768 ** 2,
            "free_bytes": free, "peak_bytes": torch.cuda.max_memory_allocated()
            - base, "ms": ev[0].elapsed_time(ev[1]),
            "logits_f32_bytes_a_layer_at_32768":
                cfg.n_heads * 32768 * 32768 * 4}


def lm_step_split(torch, model, opt_state, stream, step: int, opt_cfg):
    """One train step in its parts: host batch generation (host clock),
    then on the device timeline (CUDA events) the host-to-device copy, the
    microbatches' forward + backward with their float32 gradient sums, and
    AdamW.  Returns ``(split_ms, opt_state, batch)``."""
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.trainstep import (batch_to, named_params,
                                             value_and_grad)

    t0 = time.perf_counter()
    batch = stream.batch_at(step)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    b = batch_to(batch, "cuda")
    ev[1].record()
    params = named_params(model)
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device="cuda")
             for k, p in params.items()}
    n = LM_MICROBATCHES
    for i in range(n):
        one = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
               for k, x in b.items()}
        _, g = value_and_grad(transformer.loss_fn, model, one)
        for k, gk in g.items():
            grads[k] += gk
        del g
    grads = {k: g / n for k, g in grads.items()}
    ev[2].record()
    _, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    names = ("h2d", "forward_backward", "optimizer")
    split = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in enumerate(names)}
    split["host_batch"] = host_ms
    return split, opt_state, batch


def lm_phase(torch, card: str):
    """Phase 10: the dense LM on the card.  ``drive``, the launch window's
    whole content: (a) ``repro_torch.launch.train.main`` trains qwen2-1.5b
    at its published size (28 layers, d_model 1536, GQA 12/2, d_ff 8960,
    vocab 151,936, QKV bias; 1,777,088,000 parameters) for 2 steps at
    train_4k's sequence length 4096, batch 4 in 2 microbatches, then writes
    its final checkpoint.  ``finish(out, launches)``, after the window:
    (a)'s checks (``final step=3`` printed, finite losses, every leaf moved,
    the checkpoint's step and a leaf read back), one step split into its
    parts and one under ``torch.profiler``, the model FLOPs; (b) qwen3-8b
    and minitron-8b at full width and 2 layers, card against CPU in float32
    and against a float64 run on the card in bfloat16; (c) qwen3-8b at
    its published size, decode against forward, ``decode_32k`` at batch 4,
    then on (a)'s weights ``long_500k`` and ``prefill_32k``.  Returns
    ``(drive, finish)``."""
    import contextlib
    import dataclasses
    import gc
    import io
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.train.data import TokenStream
    from repro_torch.train.optimizer import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    arch = get_arch(LM_ARCH)
    cfg = arch.config
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="lm.", dir=ROOT / "build"))
    free = shutil.disk_usage(work).free
    check(free >= LM_FREE_BYTES,
          f"phase 10: {free / 1e9:.1f} GB free under {work}; the qwen2-1.5b "
          f"checkpoint takes about 21.3 GB and the phase asks for "
          f"{LM_FREE_BYTES / 1e9:.0f} GB")
    argv = ["--arch", LM_ARCH, "--preset", "full", "--batch", str(LM_BATCH),
            "--seq", str(LM_SEQ), "--microbatches", str(LM_MICROBATCHES),
            "--steps", str(LM_STEPS), "--device", "cuda", "--ckpt-dir",
            str(work)]

    def drive():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer = launch_train.main(argv)
        torch.cuda.synchronize()
        return {"trainer": trainer, "printed": out.getvalue(),
                "wall_s": time.perf_counter() - t0, "base_bytes": base,
                "held_before_phase": held,
                "peak_bytes": torch.cuda.max_memory_allocated()}

    def finish(got: dict, launched: dict) -> dict:
        t_start = time.perf_counter()
        trainer = got.pop("trainer")
        model = trainer.params
        n_params = sum(p.numel() for p in model.parameters())
        info = {"card": card, "launches": launched, "config": {
            "arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "params": n_params, "batch": LM_BATCH,
            "seq": LM_SEQ, "microbatches": LM_MICROBATCHES,
            "steps": LM_STEPS}, "train": dict(got)}
        print(got["printed"], end="", flush=True)
        check(f"final step={LM_STEPS} loss=" in got["printed"],
              f"phase 10 (a): no 'final step={LM_STEPS}' line: "
              f"{got['printed']!r}")
        check(n_params == LM_PARAMS,
              f"phase 10 (a): {n_params} parameters, not {LM_PARAMS}")
        losses = [r["loss"] for r in trainer.metrics_log]
        check(bool(losses) and all(np.isfinite(losses)),
              f"phase 10 (a): loss {losses}")
        init = launch_train.model_for(
            arch, cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
        still = [k for (k, a), b in zip(init.named_parameters(),
                                         model.parameters())
                 if not bool((a != b).any())]
        del init
        check(not still, f"phase 10 (a): leaves that did not move: {still}")
        step_dir = work / LM_ARCH / f"step_{LM_STEPS:012d}"
        meta = json.loads((step_dir / "meta.json").read_text())
        saved = torch.load(step_dir / "params.pt", mmap=True,
                           weights_only=True)
        rows = saved["k:embed"][:4096]
        check(meta["step"] == LM_STEPS
              and trainer.ckpt.all_steps() == [LM_STEPS]
              and torch.equal(rows, model.embed[:4096].detach().cpu()),
              "phase 10 (a): the checkpoint does not read back")
        info["train"]["checkpoint_bytes"] = sum(
            f.stat().st_size for f in step_dir.iterdir())
        del saved, rows
        shutil.rmtree(work / LM_ARCH)
        info["train"]["losses"] = losses
        log(f"phase 10 (a) {card}: {LM_ARCH} ({n_params} params) trained "
            f"{LM_STEPS} steps at batch {LM_BATCH} x {LM_SEQ} in "
            f"{got['wall_s']:.1f} s (losses {losses}); peak device memory "
            f"{got['peak_bytes']} B ({got['base_bytes']} B before); "
            f"checkpoint {info['train']['checkpoint_bytes']} B read back")

        # one step in its parts, then one under the profiler
        opt_cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=LM_STEPS)
        split, state, batch = lm_step_split(torch, model, trainer.opt_state,
                                            trainer.stream, LM_STEPS, opt_cfg)
        prof = profile_query(torch, lambda: trainer.step_fn(model, state,
                                                            batch))
        step_ms = split["h2d"] + split["forward_backward"] + split["optimizer"]
        tokens = LM_BATCH * LM_SEQ
        dense = n_params - cfg.vocab * cfg.d_model  # the embedding is a gather
        attn = 12 * cfg.n_layers * LM_BATCH * LM_SEQ ** 2 * cfg.n_heads \
            * cfg.d_head  # the plain attention's full S x S products
        flops = 6 * dense * tokens + attn
        info["step_split_ms"] = split
        info["profile"] = prof
        info["model_flops"] = {
            "per_step": flops, "dense_6nt": 6 * dense * tokens,
            "attention": attn, "step_ms": step_ms,
            "tflops_s": flops / (step_ms * 1e-3) / 1e12,
            "of_bf16_peak": flops / (step_ms * 1e-3) / PEAK_BF16_S}
        del trainer, state, batch
        mf = info["model_flops"]
        log(f"phase 10 {card}: one step: host batch "
            f"{split['host_batch']:.1f} ms, h2d {split['h2d']:.2f} ms, "
            f"forward + backward {split['forward_backward']:.1f} ms, AdamW "
            f"{split['optimizer']:.1f} ms (device timeline); "
            f"{mf['tflops_s']:.1f} TFLOP/s of model FLOPs, "
            f"{mf['of_bf16_peak']:.3f} of the bf16 peak; the device is busy "
            f"{prof['device_busy_share']} of a profiled step "
            f"({prof['cuda_kernels']} CUDA kernels)")

        # (c) long_500k and prefill_32k on (a)'s weights
        gc.collect()
        torch.cuda.empty_cache()
        b, length, steps = LM_LONG_500K
        info["long_500k"] = lm_decode_cell(torch, model, b, length, steps,
                                           seed=5)
        info["prefill_32k"] = lm_prefill(torch, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 10 (c) {card}: long_500k {info['long_500k']}; "
            f"prefill_32k {info['prefill_32k']}")

        # (c) qwen3-8b at its published size
        big_arch = get_arch(LM_DECODE_ARCH)
        big = lm_model(torch, LM_DECODE_ARCH, big_arch.config, "cuda", seed=2)
        prompt = torch.from_numpy(TokenStream(
            vocab=big_arch.config.vocab, batch=2, seq=LM_PROMPT,
            seed=0).batch_at(0)["tokens"]).cuda()
        dvf = lm_decode_vs_forward(torch, big, prompt)
        info["decode_vs_forward"] = dvf
        for dt, row in dvf.items():
            check(row["max_abs_of_max"] <= LM_DECODE_TOL[dt],
                  f"phase 10 (c): {LM_DECODE_ARCH} decode differs from "
                  f"forward in {dt}: {row}")
        b, length, steps = LM_DECODE_32K
        info["decode_32k"] = lm_decode_cell(torch, big, b, length, steps,
                                            seed=6)
        info["decode_params"] = sum(p.numel() for p in big.parameters())
        del big
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 10 (c) {card}: {LM_DECODE_ARCH} decode against forward "
            f"{ {dt: r['max_abs_of_max'] for dt, r in dvf.items()} }; "
            f"decode_32k {info['decode_32k']}")

        # (b) full width, depth 2, card against CPU (float32) and float64
        info["card_vs_cpu"] = {}
        for name in LM_B_ARCHS:
            got_b = lm_card_vs_cpu(torch, name)
            info["card_vs_cpu"][name] = got_b
            log(f"phase 10 (b) {card}: {name}: " + "; ".join(
                f"{dt} loss {got_b[dt]['loss']} grad norm "
                f"{got_b[dt]['grad_norm']} worst {got_b[dt]['worst']} "
                f"({got_b[dt]['cpu_s']:.1f} s; "
                + (f"the CPU's gradients {got_b[dt]['cpu_grads_s']:.1f} s, "
                   f"their AdamW step on the card "
                   f"{got_b[dt]['cpu_grads_adamw_s']:.1f} s)"
                   if dt in LM_B_CPU_DTYPES else "no CPU run)")
                for dt in ("float32", "bfloat16")))
            lm_check_b(name, got_b)
            gc.collect()
            torch.cuda.empty_cache()
        shutil.rmtree(work)
        info["finish_s"] = time.perf_counter() - t_start
        return info

    return drive, finish


# ------------------------------------------------------------ phase 11: moe

# (a): deepseek-v2-236b (configs/deepseek_v2_236b.py) at full width, depth
# cut from 60 to 2 layers (its dense first layer and one MoE layer:
# 5,358,649,344 parameters by LMConfig.param_count, which leaves out the
# norms' gains, 21.4 GB in float32; all 60 layers would hold 943 GB); (c):
# dbrx-132b (configs/dbrx_132b.py) at full width, depth cut from 40 to 2
# (two MoE layers: 7,751,270,400 parameters, 31.0 GB)
MOE_A_ARCH = "deepseek-v2-236b"
MOE_A_PARAMS = 5_358_649_344
MOE_C_ARCH = "dbrx-132b"
MOE_C_PARAMS = 7_751_270_400
MOE_LAYERS = 2
# decode against forward: a 32-token prompt at batch 2 (TokenStream seed 0)
MOE_PROMPT = 32
# decode_32k at DeepSeek's published batch of 128 (its MLA cache at depth
# 2 is 9.66 GB); DBRX's batch is the largest that fits (its GQA cache at
# 128 lanes would be 34.4 GB, and each step widens a layer's keys to
# float32), reckoned from one step's peak at MOE_DECODE_PROBE lanes
MOE_DECODE_32K = (128, 32768, 8)  # batch, cache length, steps
MOE_LONG_500K = (1, 524288, 4)
MOE_DECODE_PROBE = 4
# prefill: one layer's float32 logits are 128 · S² · 4 B for DeepSeek
# (8.6 GB at 4096, 34.4 GB at 8192) and 48 · S² · 4 B for DBRX, so the
# probes stay short
MOE_PREFILL_PROBES = (1024, 2048, 3072)
# (b): card against CPU at full width, batch 2 x 64 (TokenStream seed 0):
# DeepSeek at depth 2, DBRX at depth 1 (at depth 2 its weights, two sets
# of gradients and the saved bf16 casts come to about 81 GB); the float64
# truth runs on the card in passes, each taking the gradients of leaves
# holding at most MOE_TRUTH_PASS_BYTES in float64 (DeepSeek's whole
# float64 model and gradients would take 86 GB)
MOE_B_LAYERS = {MOE_A_ARCH: 2, MOE_C_ARCH: 1}
MOE_B_BATCH = 2
MOE_B_SEQ = 64
# the dtypes whose gradients also run on the CPU: the bfloat16 CPU run
# (26.7 s DeepSeek, 29.5 s DBRX on the H100's host) is cut for the
# script's time limit, when phase 13 grew.  In bfloat16 the card's two
# runs are still held bit-equal, and its gradients to the float64 run's,
# each leaf within MOE_GRAD_RTOL / MOE_EXPERT_GRAD_RTOL (set from both
# devices' distances to float64, the card's alone 0.088 and 0.158)
MOE_B_CPU_DTYPES = ("float32",)
MOE_TRUTH_PASS_BYTES = 16e9
# (d): each arch's smoke preset through launch.train.main
MOE_TRAIN_STEPS = 3
MOE_FREE_BYTES = 1e9
# (b)'s tolerances, card against CPU, from the first chip run of (b)
# (H100, PERF.md §6): two card runs are equal bit for bit, and each
# device's gradients lie from the float64 run's by up to 3.7e-6 (card)
# and 2.4e-6 (CPU) norm-wise a leaf in float32, so two devices can differ
# by the sum: a leaf within 3e-5 (measured 3.9e-6), as phase 10.  In
# bfloat16 the router's bf16 logits send some tokens to other experts
# than the float64 run does, and the two devices' rounding differs
# likewise: the expert stacks (w_gate, w_up, w_down) lie 0.158 (card) and
# 0.176 (CPU) from float64, the other leaves up to 0.088 and 0.100 (the
# router), so a leaf within 0.35 and 0.2 (measured 0.126 and 0.045; a
# wrong gradient misses by 1 or more).  The loss: within 1e-6 (float32,
# measured 8e-8) and 6e-4 (bfloat16: 2.8e-4 and 2.5e-4 from float64;
# measured 3.8e-5); the gradient norm within 1e-5 and 1e-3 (7.2e-4 and
# 1.9e-4 from float64; measured 6.8e-8 and 5.2e-4)
MOE_LOSS_RTOL = {"float32": 1e-6, "bfloat16": 6e-4}
MOE_GNORM_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
MOE_GRAD_RTOL = {"float32": 3e-5, "bfloat16": 0.2}
MOE_EXPERT_GRAD_RTOL = {"float32": 3e-5, "bfloat16": 0.35}
MOE_EXPERT_LEAVES = (".moe.w_gate", ".moe.w_up", ".moe.w_down")
# decode against forward (capacity_factor = E / k: no token dropped): the
# largest difference of a position's logits over the forward's largest
# |logit|, and the median position's.  In float32 the two sum in other
# orders (measured 3.0e-6 DeepSeek, 4.2e-6 DBRX; held to phase 10's
# 5e-5).  In bfloat16 a router's near-tie can pick another expert for a
# token in a decode step (2 rows) than in the forward (64 rows), whose
# bf16 products round otherwise; that token's logits then move by another
# expert's output.  The first chip run of this phase measured 0.184 at 3
# of DBRX's 32 positions (median 0.0125) and 0.083 for DeepSeek against
# phase 10's dense bound of 0.1 (qwen3-8b: 0.020), so the largest
# position is held to 0.25 and the median one, where no expert flipped,
# to 0.03
MOE_DECODE_TOL = {"float32": 5e-5, "bfloat16": 0.25}
MOE_DECODE_MEDIAN_TOL = {"float32": 5e-5, "bfloat16": 0.03}


def moe_drops(torch, model, cache, tokens) -> dict:
    """One more decode step of ``tokens`` on ``cache`` with each MoE
    layer's routing counted: per layer the tokens it routed together, its
    capacity and the share of (token, expert) assignments ``moe_apply``
    drops (those past capacity, and the one at C - 1 of an expert over
    it)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    counted = []
    orig = transformer.moe_apply

    def counting(moe, x, mcfg):
        _, top_i, _ = moe_mod.route(x, moe.router, mcfg)
        count = torch.bincount(top_i.reshape(-1), minlength=mcfg.n_experts)
        cap = moe_mod.capacity(x.shape[0], mcfg)
        kept = torch.where(count > cap, cap - 1, count).sum()
        counted.append((x.shape[0], cap, kept, top_i.numel()))
        return orig(moe, x, mcfg)

    transformer.moe_apply = counting
    try:
        transformer.decode_step(model, cache, tokens)
    finally:
        transformer.moe_apply = orig
    return {"layers": [{"tokens": t, "cap": c,
                        "dropped_share": 1.0 - int(kept) / n}
                       for t, c, kept, n in counted]}


def moe_decode_batch(torch, model, length: int) -> dict:
    """The largest decode batch, a multiple of 8 up to 128, whose step fits
    in 90% of the free device memory, reckoned from above: one step's peak
    (the cache included) at ``MOE_DECODE_PROBE`` lanes, plus for each lane
    more its cache and the most a GQA step adds a lane (one layer's keys
    widened to float32, twice, and three float32 copies of its logits).
    The two probes of a fit would both see the MoE layer's weight casts,
    not the attention's widening, so the lanes' cost is counted, not
    fitted."""
    from repro_torch.models import transformer

    cfg = model.cfg
    b0 = MOE_DECODE_PROBE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cache = transformer.init_cache(cfg, b0, length, device="cuda")
    cache["pos"].fill_(length - 1)
    tok = torch.zeros((b0, 1), dtype=torch.int32, device="cuda")
    logits, cache = transformer.decode_step(model, cache, tok)
    torch.cuda.synchronize()
    probe = torch.cuda.max_memory_allocated() - base
    cache_lane = sum(v[:, :1].numel() * v.element_size()
                     for k, v in cache.items() if k != "pos")
    del logits, cache
    per_lane = cache_lane + 2 * length * cfg.n_kv_heads * cfg.d_head * 4 \
        + 3 * cfg.n_heads * length * 4
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fits = [b for b in range(8, 129, 8)
            if probe + per_lane * (b - b0) <= 0.9 * free]
    check(bool(fits), f"phase 11: no decode batch fits {free} B")
    return {"batch": fits[-1], "probe_lanes": b0, "probe_peak": probe,
            "per_lane_bytes": per_lane, "free_bytes": free}


def moe_cut(torch, name: str, layers: int, device, seed: int):
    """``name``'s published config at ``layers`` layers, its weights drawn
    from ``seed`` on ``device``."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(name).config, n_layers=layers)
    return lm_model(torch, name, cfg, device, seed=seed)


def moe_serve(torch, name: str, seed: int, decode_batch, what: str) -> dict:
    """(a) or (c) for one arch at ``MOE_LAYERS`` layers: decode against
    forward with no token dropped (capacity_factor = E / k, as the
    reference's own test raises it), then at the published capacity
    ``decode_32k`` (``decode_batch`` lanes, or the largest that fits when
    None) with the dropped share of one more step, ``long_500k`` for MLA,
    and ``prefill_32k``.  Each part's peak device memory above what the
    phase started with is recorded."""
    import dataclasses
    import gc

    from repro_torch.train.data import TokenStream

    out = {}
    base_bytes = torch.cuda.memory_allocated()

    def part(key, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[key] = fn()
        torch.cuda.synchronize()
        out.setdefault("peak_bytes", {})[key] = \
            torch.cuda.max_memory_allocated() - base_bytes
        out.setdefault("wall_s", {})[key] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

    model = moe_cut(torch, name, MOE_LAYERS, "cuda", seed)
    cfg = model.cfg
    out["params"] = sum(p.numel() for p in model.parameters())
    # LMConfig.param_count's count: the matrices, not the norms' gains
    out["matrix_params"] = sum(p.numel() for p in model.parameters()
                               if p.dim() > 1)
    out["param_count"] = cfg.param_count()
    out["weight_bytes"] = torch.cuda.memory_allocated() - base_bytes
    m = cfg.moe
    prompt = torch.from_numpy(TokenStream(
        vocab=cfg.vocab, batch=2, seq=MOE_PROMPT, seed=0).batch_at(0)[
            "tokens"]).cuda()
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    part("decode_vs_forward",
         lambda: lm_decode_vs_forward(torch, model, prompt))
    model.cfg = cfg
    b, length, steps = MOE_DECODE_32K
    if decode_batch is None:
        part("decode_batch", lambda: moe_decode_batch(torch, model, length))
        b = out["decode_batch"]["batch"]
    part("decode_32k", lambda: lm_decode_cell(
        torch, model, b, length, steps, seed=seed + 10, what=what,
        after=lambda mdl, cache, tok: moe_drops(torch, mdl, cache, tok)))
    if cfg.attn == "mla":
        b, length, steps = MOE_LONG_500K
        part("long_500k", lambda: lm_decode_cell(
            torch, model, b, length, steps, seed=seed + 20, what=what))
    part("prefill_32k", lambda: lm_prefill(torch, model, MOE_PREFILL_PROBES,
                                           what))
    del model
    return out


def moe_train(torch, name: str, work: Path) -> dict:
    """(d): ``launch.train.main`` on ``name``'s smoke preset for
    ``MOE_TRAIN_STEPS`` steps on the card: what it printed, its losses,
    and the leaves that did not move from the seed-0 weights it started
    from."""
    import contextlib
    import io

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train

    arch = get_arch(name)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        trainer = launch_train.main(
            ["--arch", name, "--steps", str(MOE_TRAIN_STEPS), "--device",
             "cuda", "--ckpt-dir", str(work)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    init = launch_train.model_for(
        arch, arch.smoke()[0], "cuda",
        torch.Generator(device="cuda").manual_seed(0))
    model = trainer.params
    leaves = [k for k, _ in model.named_parameters()]
    still = [k for (k, a), b in zip(init.named_parameters(),
                                     model.parameters())
             if not bool((a != b).any())]
    return {"printed": buf.getvalue(), "wall_s": wall, "leaves": leaves,
            "still": still,
            "losses": [r["loss"] for r in trainer.metrics_log]}


def moe_truth(torch, card, batch) -> tuple[float, float, dict]:
    """The float64 run on the card: ``card`` converted in place (its
    float32 weights are exact in float64), its compute in float64, the
    gradients taken in passes of at most ``MOE_TRUTH_PASS_BYTES`` of
    float64 leaves; returns the loss, the gradient norm and each leaf's
    gradient in float32 on the host.  ``card`` goes back to float32 (and
    its config) after."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.train.trainstep import batch_to, named_params

    cfg = card.cfg
    card.double()
    card.cfg = dataclasses.replace(cfg, compute_dtype="float64",
                                   attn_fp32_logits=False)
    params = named_params(card)
    passes, size = [[]], 0.0
    for k, p in params.items():
        if passes[-1] and size + 8 * p.numel() > MOE_TRUTH_PASS_BYTES:
            passes.append([])
            size = 0.0
        passes[-1].append(k)
        size += 8 * p.numel()
    b = batch_to(batch, "cuda")
    truth, sq = {}, 0.0
    for names in passes:
        loss = transformer.loss_fn(card, b)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        for k, g in zip(names, grads):
            sq += float(torch.linalg.vector_norm(g)) ** 2
            truth[k] = g.float().cpu()
        del grads
    loss = float(loss.detach())
    card.float()
    card.cfg = cfg
    return loss, sq ** 0.5, {"truth": truth, "passes": len(passes)}


def moe_digest(torch, g) -> tuple[int, int]:
    """Two sums of a float32 leaf's bit patterns, plain and weighted by
    position (int64, wrapping): equal leaves give equal digests, and two
    runs whose bits differ anywhere (a swap of two elements included) give
    different ones but by a wrap-around coincidence.  Two gradient sets of
    21 GB cannot be on the card at once."""
    bits = g.reshape(-1).view(torch.int32)
    plain = weighted = 0
    for lo in range(0, bits.numel(), CHUNK):
        x = bits[lo:lo + CHUNK].long()
        i = torch.arange(lo + 1, lo + 1 + x.numel(), device=x.device)
        plain += int(x.sum())
        weighted += int((x * i).sum())
    return plain, weighted


def moe_card_vs_cpu(torch, name: str) -> dict:
    """(b) for one arch at full width and ``MOE_B_LAYERS[name]`` layers:
    the float64 truth on the card (``moe_truth``), then in float32 and in
    bfloat16 two runs on the card and (dtypes of ``MOE_B_CPU_DTYPES``)
    one on the CPU from the same weights.  Per dtype: the losses (with aux), the gradient norms,
    whether the two card runs are equal bit for bit (leaf digests,
    ``moe_digest``), and per leaf the norm-wise gaps card-CPU,
    card-float64 and CPU-float64 (the largest of each).  The comparisons
    run on the card, each host tensor crossing once."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.train.data import TokenStream
    from repro_torch.train.optimizer import global_norm

    arch = get_arch(name)
    base = dataclasses.replace(arch.config, n_layers=MOE_B_LAYERS[name])
    batch = TokenStream(vocab=base.vocab, batch=MOE_B_BATCH, seq=MOE_B_SEQ,
                        seed=0).batch_at(0)
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    card = lm_model(torch, name, base, "cuda", seed=4)
    cpu = lm_model(torch, name, base, "cpu", state=card.state_dict())
    l64, gn64, t = moe_truth(torch, card, batch)
    truth = t.pop("truth")
    out = {"layers": base.n_layers,
           "params": sum(p.numel() for p in card.parameters()),
           "card_bytes_before": held, "host_available_bytes":
               host_available(),
           "float64": {"loss": l64, "grad_norm": gn64, **t,
                       "s": time.perf_counter() - t0}}
    for dt in ("float32", "bfloat16"):
        card.cfg = cpu.cfg = dataclasses.replace(base, compute_dtype=dt)
        on_cpu = dt in MOE_B_CPU_DTYPES
        t_h = time.perf_counter()
        l_h, g_h = lm_grads(torch, cpu, batch) if on_cpu else (None, {})
        gn_h = float(global_norm(g_h)) if on_cpu else None
        t_c = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        l_c, g_c = lm_grads(torch, card, batch)
        digests = {k: moe_digest(torch, g) for k, g in g_c.items()}
        leaves = {k: {} for k in g_c}
        for k in list(g_c):
            tr = truth[k].to("cuda")
            leaves[k]["card_f64"] = lm_rel(torch, g_c[k], tr)
            if on_cpu:
                g = g_h.pop(k).to("cuda")
                leaves[k].update(card_cpu=lm_rel(torch, g_c[k], g),
                                 cpu_f64=lm_rel(torch, g, tr))
                del g
            del tr
        gn_c = float(global_norm(g_c))
        del g_c
        l_c2, g_c2 = lm_grads(torch, card, batch)
        differ = [k for k, g in g_c2.items()
                  if moe_digest(torch, g) != digests[k]]
        del g_c2
        row = {"loss": [l_c, l_h], "loss_card_again": l_c2,
               "grad_norm": [gn_c, gn_h],
               "card_bit_equal": l_c == l_c2 and not differ,
               "card_leaves_differ": differ,
               "leaves": leaves,
               "cpu_grads_s": t_c - t_h if on_cpu else None,
               "card_s": time.perf_counter() - t_c,
               "card_peak_bytes": torch.cuda.max_memory_allocated() - held}
        row["worst"] = {f: max((v[f], k) for k, v in leaves.items())
                        for f in (("card_cpu", "card_f64", "cpu_f64")
                                  if on_cpu else ("card_f64",))}
        out[dt] = row
    del card, cpu, truth
    out["seconds"] = time.perf_counter() - t0
    return out


def moe_check_b(name: str, got: dict) -> None:
    """(b)'s checks: the two card runs equal bit for bit (the MoE
    dispatch and combine are deterministic), and the loss, gradient norm
    and each gradient leaf norm-wise, card against CPU, within ``MOE_*``;
    in a dtype without a CPU run (``MOE_B_CPU_DTYPES``) each gradient leaf
    against the float64 run's."""
    for dt in ("float32", "bfloat16"):
        row = got[dt]
        (l_c, l_h), (g_c, g_h) = row["loss"], row["grad_norm"]
        check(row["card_bit_equal"],
              f"phase 11 (b) {name} {dt}: two card runs differ: loss "
              f"{l_c} and {row['loss_card_again']}, leaves "
              f"{row['card_leaves_differ']}")
        if dt not in MOE_B_CPU_DTYPES:
            for k, v in row["leaves"].items():
                tol = (MOE_EXPERT_GRAD_RTOL if k.endswith(MOE_EXPERT_LEAVES)
                       else MOE_GRAD_RTOL)[dt]
                check(v["card_f64"] <= tol,
                      f"phase 11 (b) {name} {dt}: gradient {k} differs from "
                      f"the float64 run's by more than {tol}: {v}")
            continue
        check(abs(l_c - l_h) <= MOE_LOSS_RTOL[dt] * abs(l_h),
              f"phase 11 (b) {name} {dt}: loss {l_c} on the card, {l_h} on "
              f"the CPU")
        check(abs(g_c - g_h) <= MOE_GNORM_RTOL[dt] * abs(g_h),
              f"phase 11 (b) {name} {dt}: gradient norm {g_c} on the card, "
              f"{g_h} on the CPU")
        for k, v in row["leaves"].items():
            tol = (MOE_EXPERT_GRAD_RTOL if k.endswith(MOE_EXPERT_LEAVES)
                   else MOE_GRAD_RTOL)[dt]
            check(v["card_cpu"] <= tol,
                  f"phase 11 (b) {name} {dt}: gradient {k} differs from the "
                  f"CPU's by more than {tol}: {v}")


def host_available() -> int:
    """MemAvailable of the host, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return -1


def moe_phase(torch, card: str):
    """Phase 11: MoE and MLA at full width on the card.  ``drive``, the
    launch window's whole content: (a) deepseek-v2-236b at depth 2 (its
    dense first layer and one MoE layer; MLA with the absorbed decode
    cache; 5,358,649,344 parameters) and (c) dbrx-132b at depth 2 (GQA, two
    16-expert MoE layers; 7,751,270,400 parameters), each from seeded
    weights (``moe_serve``): a 32-token prompt at batch 2 fed token by
    token through ``decode_step`` against ``forward`` in float32 and in
    bfloat16 compute, run with capacity_factor = E / k (26.7 and 4) so
    that no token can be dropped, as the reference's own
    ``test_mla_decode_matches_forward`` raises it (decode routes B tokens
    a step, the forward B·S, so at the published capacity they drop
    different ones); then at the published capacity_factor of 1.25
    ``decode_32k`` (DeepSeek at its published batch of 128 from a 9.66 GB
    cache; DBRX at the largest batch that fits), each step timed against
    its bound (float32 weights plus the cache over 3.35 TB/s) and the
    dropped share of one more step recorded, DeepSeek's ``long_500k``
    (batch 1, a 1.21 GB cache) and ``prefill_32k`` cut to the longest
    multiple of 4096 whose plain attention fits; (d) each arch's smoke
    preset trained for 3 steps through ``launch.train.main``.
    ``finish(out, launches)``, after the window: the checks of (a), (c)
    and (d) (``final step=3`` printed, finite losses, every leaf moved,
    the router included), the cache bytes a token and layer, and (b)
    DeepSeek at depth 2 and DBRX at depth 1, batch 2 x 64, card against
    CPU in float32 (``MOE_B_CPU_DTYPES``) and against a float64 run on
    the card in bfloat16, and in both two card runs equal bit for bit.  Returns ``(drive, finish)``."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="moe.", dir=ROOT / "build"))
    free = shutil.disk_usage(work).free
    check(free >= MOE_FREE_BYTES,
          f"phase 11: {free / 1e9:.1f} GB free under {work}")

    def drive():
        t0 = time.perf_counter()
        out = {"held_before_phase": held}
        out["a"] = moe_serve(torch, MOE_A_ARCH, 2, MOE_DECODE_32K[0],
                             "phase 11 (a)")
        out["c"] = moe_serve(torch, MOE_C_ARCH, 3, None, "phase 11 (c)")
        out["d"] = {name: moe_train(torch, name, work)
                    for name in (MOE_A_ARCH, MOE_C_ARCH)}
        gc.collect()
        torch.cuda.empty_cache()
        out["drive_s"] = time.perf_counter() - t0
        return out

    def finish(got: dict, launched: dict) -> dict:
        t_start = time.perf_counter()
        info = {"card": card, "launches": launched, **got}
        for key, name, n in (("a", MOE_A_ARCH, MOE_A_PARAMS),
                             ("c", MOE_C_ARCH, MOE_C_PARAMS)):
            row = got[key]
            check(row["matrix_params"] == row["param_count"] == n,
                  f"phase 11 ({key}): {name} has {row['matrix_params']} "
                  f"matrix parameters (param_count {row['param_count']}), "
                  f"not {n}")
            for dt, r in row["decode_vs_forward"].items():
                r["median_position"] = float(np.median(r["per_position"]))
                check(r["max_abs_of_max"] <= MOE_DECODE_TOL[dt]
                      and r["median_position"] <= MOE_DECODE_MEDIAN_TOL[dt],
                      f"phase 11 ({key}): {name} decode differs from "
                      f"forward in {dt}: {r}")
            dvf = {dt: (r["max_abs_of_max"], r["median_position"])
                   for dt, r in row["decode_vs_forward"].items()}
            log(f"phase 11 ({key}) {card}: {name} at depth {MOE_LAYERS} "
                f"({row['params']} params): decode against forward {dvf} "
                f"(largest, median position); "
                f"decode_32k batch {row['decode_32k']['batch']} "
                f"{row['decode_32k']['ms_per_step']} ms a step, bound "
                f"{row['decode_32k']['bound_ms']:.2f} ms, dropped "
                f"{row['decode_32k']['after']}; "
                + (f"long_500k {row['long_500k']['ms_per_step']} ms, bound "
                   f"{row['long_500k']['bound_ms']:.2f} ms; "
                   if "long_500k" in row else "")
                + f"prefill {row['prefill_32k']['seq']} tokens "
                f"{row['prefill_32k']['ms']:.1f} ms; peak above the phase's "
                f"start {row['peak_bytes']}; wall {row['wall_s']}")
        cfg = get_arch(MOE_A_ARCH).config
        info["cache_bytes_a_token_and_layer"] = {
            "mla": (cfg.kv_lora + cfg.rope_head_dim) * 2,
            "full_kv": cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim
                                      + cfg.v_head_dim) * 2}
        for name, row in got["d"].items():
            check(f"final step={MOE_TRAIN_STEPS} loss=" in row["printed"],
                  f"phase 11 (d): {name}: no 'final step="
                  f"{MOE_TRAIN_STEPS}' line: {row['printed']!r}")
            check(bool(row["losses"]) and all(np.isfinite(row["losses"])),
                  f"phase 11 (d): {name}: losses {row['losses']}")
            check(not row["still"] and any(".moe.router" in k
                                           for k in row["leaves"]),
                  f"phase 11 (d): {name}: leaves that did not move: "
                  f"{row['still']}")
            log(f"phase 11 (d) {card}: {name} smoke preset trained "
                f"{MOE_TRAIN_STEPS} steps through launch.train.main in "
                f"{row['wall_s']:.1f} s, losses {row['losses']}; every "
                f"leaf moved, routers included")
        shutil.rmtree(work)
        info["card_vs_cpu"] = {}
        for name in MOE_B_LAYERS:
            gc.collect()
            torch.cuda.empty_cache()
            got_b = moe_card_vs_cpu(torch, name)
            info["card_vs_cpu"][name] = got_b
            log(f"phase 11 (b) {card}: {name} at depth "
                f"{got_b['layers']} ({got_b['params']} params): float64 "
                f"loss {got_b['float64']['loss']} in "
                f"{got_b['float64']['passes']} passes; " + "; ".join(
                    f"{dt} loss {got_b[dt]['loss']} grad norm "
                    f"{got_b[dt]['grad_norm']} card runs bit-equal "
                    f"{got_b[dt]['card_bit_equal']} worst "
                    f"{got_b[dt]['worst']} (CPU "
                    + (f"{got_b[dt]['cpu_grads_s']:.1f} s"
                       if dt in MOE_B_CPU_DTYPES else "cut")
                    + f", card {got_b[dt]['card_s']:.1f} s, card peak "
                    f"{got_b[dt]['card_peak_bytes']} B)"
                    for dt in ("float32", "bfloat16"))
                + f"; host available {got_b['host_available_bytes']} B; "
                f"{got_b['seconds']:.1f} s")
            moe_check_b(name, got_b)
        gc.collect()
        torch.cuda.empty_cache()
        info["finish_s"] = time.perf_counter() - t_start
        return info

    return drive, finish


# ------------------------------------------------------------ phase 12: gnn

# (a): PNA at its published widths (4 layers, hidden 75, d_feat 1433, 16
# classes) through launch.train.main on the sampled stream, card and CPU
# from the weights of one seed
GNN_A_ARCH = "pna"
GNN_A_STEPS = 20
# (b): each arch at its published widths on the GNN_SHAPES cells whose
# training step fits one card; ogb_products fits none ((c))
GNN_B_CELLS = (("pna", "minibatch_lg"), ("pna", "full_graph_sm"),
               ("meshgraphnet", "minibatch_lg"), ("meshgraphnet", "molecule"),
               ("meshgraphnet", "full_graph_sm"),
               ("dimenet", "minibatch_lg"), ("dimenet", "molecule"))
GNN_SEED = 7
# (a)'s check, from the first chip runs of this phase (H100, PERF.md §6).
# The stream's labels are random, so the loss only wanders near ln 16
# (within about 1.5% over 20 steps), and each step's AdamW update is
# close to lr·sign(g): an element whose gradient two runs round apart
# near 0 moves up to 2·lr apart, and float32 rounding (1e-7 at step 2)
# grows about tenfold a step.  The card lay 8.7e-8-9.9e-6 from the CPU
# over the first three steps and up to 1.0e-2 over all 20, where any
# model with near-uniform logits would pass.  So the CPU runs the first
# GNN_A_HELD steps of the same 20-step schedule (twice: its own spread),
# and the card's losses there are held within 1e-4 of them, where a wrong
# gradient or update shows (step 1's update moves the loss by about
# 1e-3); the card's later steps only have to be finite
GNN_A_HELD = 3
GNN_A_RTOL = 1e-4
# (b)'s tolerances, card against CPU, an arch's from the first chip run
# of this phase (H100, PERF.md §6), as phases 10 (b) and 11 (b) set
# theirs: each device's float32 gradients lie from the float64 run's on
# the card by up to (card, CPU) norm-wise a leaf over the arch's cells:
# PNA 6.6e-3 and 2.6e-3 (its std aggregator's E[x²] - E[x]² cancels, and
# eps 1e-5 makes d std / d var up to 158), MeshGraphNet 1.7e-3 and 1.9e-4
# (its node encoder's first weight behind 15 LayerNorms: two card runs
# of it lay 1.7e-4 and 1.7e-3 apart), DimeNet 1.4e-4 and 1.0e-4; two
# runs can differ by the sum, so a leaf within about 2.5 times it
# (measured card against CPU: 6.5e-3, 1.7e-3, 1.5e-4).  The gradient
# norm within about three times the sum of the two sides' distances to
# float64 (PNA 6.5e-5, MeshGraphNet 1e-5, DimeNet 6e-6; measured 5.7e-5,
# 5e-6, 3.6e-6).  The loss: PNA's and
# MeshGraphNet's within 1e-6 (measured 0 and 8.9e-8); DimeNet's, a sum of
# float32 energies over up to 169,984 atoms and six blocks whose
# scatter-adds are float atomics on the card, within 1e-4 (card against
# CPU 4.2e-6; two card runs 1.5e-5 apart).  One AdamW step moves an
# element by about lr·sign(g), so an element whose gradient the two
# devices round to either side of 0 moves 2·lr apart: each leaf's new
# weights within 0.5 of its update's norm (measured up to 0.22, on a
# PNA bias whose gradient lies 6.6e-3 from float64); a wrong step (a
# missing bias correction, the wrong rate) misses by 1 or more
GNN_TOL = {"pna": {"loss": 1e-6, "gnorm": 2e-4, "grad": 2e-2},
           "meshgraphnet": {"loss": 1e-6, "gnorm": 3e-5, "grad": 5e-3},
           "dimenet": {"loss": 1e-4, "gnorm": 3e-5, "grad": 5e-4}}
GNN_ADAM_RTOL = 0.5
# (b)'s warm passes a cell: forward + backward, then AdamW, each timed
# (cut from 5 for the script's time limit)
GNN_WARM = 3
# the cells whose CPU step is cut: DimeNet's at minibatch_lg took 69-72 s
# on the GPU machine's 8-core host, more than half the phase, with the
# script near its time limit.  The card still runs the whole cell, and
# its float32 step is held to its float64 run there, within GNN_TOL (its
# CPU comparison is made at molecule)
GNN_CARD_ONLY = {("dimenet", "minibatch_lg")}


def gnn_opt():
    from repro_torch.train.optimizer import OptConfig

    return OptConfig(lr=3e-3, warmup_steps=10, total_steps=GNN_A_STEPS)


def gnn_cell_batch(torch, arch, cell: str, seed: int) -> dict:
    """A batch in the arch's own layout at ``cell``'s sizes
    (``gnn_common.cell_batch``: DimeNet's ``t = 8e`` triplets), drawn from
    ``seed`` as the smoke batches are, on the host, checked against the
    arch's ``input_specs``."""
    from repro_torch.configs.gnn_common import cell_batch

    _, batch = cell_batch(arch, cell, seed)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
    check(shapes == {k: (tuple(v.shape), v.dtype)
                     for k, v in arch.input_specs(cell).items()},
          f"phase 12: {arch.name} {cell} batch {shapes}")
    return batch


def gnn_card_cell(torch, name: str, cell: str, held: int) -> dict:
    """(b)'s card side for ``name`` at ``cell``: weights from
    ``GNN_SEED``, one step split into H2D, forward, backward and AdamW
    (CUDA events), the peak memory above the phase's start, and the same
    gradients again from the same weights (the card's own spread: its
    scatter-adds are float atomics).  Returns the step's numbers, the
    gradients and updated weights on the host, and the starting weights
    and the batch for ``gnn_compare_cell``."""
    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                             global_norm)
    from repro_torch.train.trainstep import batch_to, named_params

    arch = get_arch(name)
    cfg = arch.config_for(cell)
    t0 = time.perf_counter()
    batch = gnn_cell_batch(torch, arch, cell, GNN_SEED)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = lm_model(torch, name, cfg, "cuda", seed=GNN_SEED)
    params = named_params(model)
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    opt_state = adamw_init(params, gnn_opt())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    b = batch_to(batch, "cuda")
    ev[1].record()
    loss = arch.loss_fn(model, b)
    ev[2].record()
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True,
        materialize_grads=True)))
    ev[3].record()
    adamw_update(params, grads, opt_state, gnn_opt())
    ev[4].record()
    torch.cuda.synchronize()
    split = {nm: ev[i].elapsed_time(ev[i + 1]) for i, nm in
             enumerate(("h2d", "forward", "backward", "optimizer"))}
    split["host_batch"] = host_ms
    out = {"params": sum(p.numel() for p in params.values()),
           "shapes": {k: list(v.shape) for k, v in batch.items()},
           "split_ms": split,
           "peak_bytes": torch.cuda.max_memory_allocated() - held,
           "loss": float(loss.detach()),
           "grad_norm": float(global_norm(grads)),
           "after": {k: p.detach().to("cpu", copy=True)
                     for k, p in params.items()}}
    # GNN_WARM more passes of the step's forward and backward, warm, from
    # the same weights, then GNN_WARM AdamW updates: each part's median
    # and range, and the card's own spread (the first pass's gradients
    # against the step's)
    model.load_state_dict(state)
    warm = {"forward": [], "backward": [], "optimizer": []}
    again = loss2 = None
    for _ in range(GNN_WARM):
        torch.cuda.synchronize()
        ev[0].record()
        loss_w = arch.loss_fn(model, b)
        ev[1].record()
        grads_w = dict(zip(params, torch.autograd.grad(
            loss_w, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        ev[2].record()
        torch.cuda.synchronize()
        warm["forward"].append(ev[0].elapsed_time(ev[1]))
        warm["backward"].append(ev[1].elapsed_time(ev[2]))
        if again is None:
            again, loss2 = grads_w, float(loss_w.detach())
        del loss_w, grads_w
    for _ in range(GNN_WARM):
        ev[0].record()
        adamw_update(params, again, opt_state, gnn_opt())
        ev[1].record()
        torch.cuda.synchronize()
        warm["optimizer"].append(ev[0].elapsed_time(ev[1]))
    split["warm"] = {k: {"median": float(np.median(v)), "min": min(v),
                         "max": max(v)} for k, v in warm.items()}
    out["card_again"] = {
        "loss": loss2,
        "bit_equal": loss2 == out["loss"] and all(
            torch.equal(again[k], g) for k, g in grads.items()),
        "worst": max((lm_rel(torch, again[k], g), k)
                     for k, g in grads.items())}
    out["grads"] = {k: g.cpu() for k, g in grads.items()}
    out["_state"], out["_batch"] = state, batch
    return out


def gnn_compare_cell(torch, name: str, cell: str, rec: dict) -> dict:
    """(b)'s comparison for one cell: the float64 run on the card from
    the card step's starting weights, then (but at ``GNN_CARD_ONLY``'s
    cells) the same float32 step on the CPU; per leaf the norm-wise gaps
    card-float64, card-CPU and CPU-float64 of the gradients, and card-CPU
    of the updated weights over the CPU's update."""
    import dataclasses

    from torch.linalg import vector_norm

    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                             global_norm)
    from repro_torch.train.trainstep import (batch_to, named_params,
                                             value_and_grad)

    arch = get_arch(name)
    cfg = arch.config_for(cell)
    state, batch = rec.pop("_state"), rec.pop("_batch")
    grads, after = rec.pop("grads"), rec.pop("after")
    t0 = time.perf_counter()
    card = lm_model(torch, name, dataclasses.replace(
        cfg, compute_dtype="float64"), "cuda", state=state).double()
    l64, g64 = value_and_grad(arch.loss_fn, card, batch_to(batch, "cuda"))
    del card
    row = {"float64_loss": float(l64), "float64_s": time.perf_counter() - t0,
           "float64_grad_norm": float(torch.sqrt(sum(
               torch.sum(g * g) for g in g64.values()))),
           "leaves": {k: {"card_f64": lm_rel(torch, g.to("cuda"), g64[k])}
                      for k, g in grads.items()}}
    if (name, cell) not in GNN_CARD_ONLY:
        t_h = time.perf_counter()
        cpu = lm_model(torch, name, cfg, "cpu", state=state)
        l_h, g_h = value_and_grad(arch.loss_fn, cpu, batch)
        params_h = named_params(cpu)
        t_a = time.perf_counter()
        adamw_update(params_h, g_h, adamw_init(params_h, gnn_opt()),
                     gnn_opt())
        row.update(cpu_loss=float(l_h),
                   cpu_grad_norm=float(global_norm(g_h)),
                   cpu_grads_s=t_a - t_h,
                   cpu_adamw_s=time.perf_counter() - t_a)
        for k, g in g_h.items():
            gh = g.to("cuda")
            start = state[k].to("cuda")
            after_h = params_h[k].detach().to("cuda")
            row["leaves"][k].update(
                card_cpu=lm_rel(torch, grads[k].to("cuda"), gh),
                cpu_f64=lm_rel(torch, gh, g64[k]),
                adam_card_cpu=float(
                    vector_norm(after[k].to("cuda") - after_h,
                                dtype=torch.float64)
                    / vector_norm(after_h - start, dtype=torch.float64)
                    .clamp(min=1e-300)))
    row["worst"] = {f: max((v[f], k) for k, v in row["leaves"].items())
                    for f in next(iter(row["leaves"].values()))}
    return row


def gnn_check_b(name: str, cell: str, rec: dict) -> None:
    """(b)'s checks: loss, gradient norm, each gradient leaf norm-wise and
    the AdamW step's weights, card against CPU, within ``GNN_TOL`` and
    ``GNN_ADAM_RTOL``; at ``GNN_CARD_ONLY``'s cells the card's loss,
    gradient norm and leaves against the float64 run, within the same."""
    what = f"phase 12 (b) {name} {cell}"
    tol = GNN_TOL[name]
    other, side, leaf = (("float64", "the float64 run", "card_f64")
                         if (name, cell) in GNN_CARD_ONLY
                         else ("cpu", "the CPU", "card_cpu"))
    l_c, l_o = rec["loss"], rec[f"{other}_loss"]
    g_c, g_o = rec["grad_norm"], rec[f"{other}_grad_norm"]
    check(np.isfinite(l_c) and abs(l_c - l_o) <= tol["loss"] * abs(l_o),
          f"{what}: loss {l_c} on the card, {l_o} on {side}")
    check(abs(g_c - g_o) <= tol["gnorm"] * abs(g_o),
          f"{what}: gradient norm {g_c} on the card, {g_o} on {side}")
    for k, v in rec["leaves"].items():
        check(v[leaf] <= tol["grad"],
              f"{what}: gradient {k} differs from {side}'s: {v}")
        check(v.get("adam_card_cpu", 0.0) <= GNN_ADAM_RTOL,
              f"{what}: the AdamW step of {k} differs from the CPU's: {v}")


def gnn_ogb_cuts(torch) -> dict:
    """(c): why ``ogb_products`` (2,449,029 nodes, 61,859,140 edges, d_feat
    100) runs no arch on one card: the float32 bytes of one tensor each
    arch's step must form, against the card's free memory now."""
    from repro_torch.configs.common import GNN_SHAPES

    s = GNN_SHAPES["ogb_products"]
    e, d = s["e"], s["d_feat"]
    free, total = torch.cuda.mem_get_info()
    cuts = {
        "pna": {"tensor": "the first layer's x[src], x[dst] [E, 100] and "
                          "their concatenation [E, 200], before its MLP",
                "bytes": 4 * e * d * 4},
        "meshgraphnet": {"tensor": "the first block's edge-MLP input [E, "
                                   "384] (h[src], h[dst], edge features)",
                         "bytes": e * 3 * 128 * 4},
        "dimenet": {"tensor": "the angular basis sbf [T, 42] at T = 8E = "
                              f"{8 * e} triplets",
                    "bytes": 8 * e * 7 * 6 * 4},
    }
    for name, c in cuts.items():
        check(c["bytes"] > free, f"phase 12 (c): {name} at ogb_products "
                                 f"needs {c['bytes']} B, {free} B free")
    return {"edges": e, "free_bytes": free, "total_bytes": total,
            "cuts": cuts}


def gnn_phase(torch, card: str):
    """Phase 12: PNA, MeshGraphNet and DimeNet at their published widths on
    the card.  ``drive``, the launch window's whole content: (a)
    ``repro_torch.launch.train.main`` trains PNA (d_feat 1433) for 20
    steps on the sampled stream, every step's loss logged; (b) one step
    of each arch at each cell of ``GNN_B_CELLS`` on the card
    (``gnn_card_cell``).  ``finish(out, launches)``, after the window:
    (a)'s first ``GNN_A_HELD`` steps twice on the CPU from the same
    seed's weights, the losses against the card's; (b) each cell's
    float64 run on the card and its CPU step (``gnn_compare_cell``) within
    ``GNN_*``; (c) the ``ogb_products`` cuts.  Returns ``(drive, finish)``."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="gnn.", dir=ROOT / "build"))
    argv = ["--arch", GNN_A_ARCH, "--preset", "full", "--steps",
            str(GNN_A_STEPS), "--ckpt-dir", str(work / "cuda"),
            "--ckpt-every", "1000"]

    def every_step(args):
        trainer = build(args)
        trainer.cfg.log_every = 1
        return trainer

    build = launch_train.build

    def drive():
        t0 = time.perf_counter()
        out = {"held_before_phase": held}
        buf = io.StringIO()
        launch_train.build = every_step
        try:
            with contextlib.redirect_stdout(buf):
                trainer = launch_train.main(argv + ["--device", "cuda"])
        finally:
            launch_train.build = build
        torch.cuda.synchronize()
        out["a"] = {"printed": buf.getvalue(),
                    "params": sum(p.numel()
                                  for p in trainer.params.parameters()),
                    "losses": [r["loss"] for r in trainer.metrics_log],
                    "wall_s": time.perf_counter() - t0}
        del trainer
        out["b"] = {}
        for name, cell in GNN_B_CELLS:
            gc.collect()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            row = gnn_card_cell(torch, name, cell, held)
            row["card_s"] = time.perf_counter() - t1
            out["b"][f"{name}/{cell}"] = row
        gc.collect()
        torch.cuda.empty_cache()
        out["drive_s"] = time.perf_counter() - t0
        return out

    def finish(got: dict, launched: dict) -> dict:
        t_start = time.perf_counter()
        info = {"card": card, "launches": launched, **got}
        a = got["a"]
        check(f"final step={GNN_A_STEPS} loss=" in a["printed"],
              f"phase 12 (a): no 'final step={GNN_A_STEPS}' line: "
              f"{a['printed']!r}")
        arch = get_arch(GNN_A_ARCH)
        init = launch_train.model_for(
            arch, arch.config, "cuda",
            torch.Generator(device="cuda").manual_seed(0))
        init = {k: v.cpu() for k, v in init.state_dict().items()}
        runs = []
        t_cpu = time.perf_counter()
        for i in range(2):  # twice: the CPU's own spread
            tr = launch_train.build(launch_train.parse_args(
                argv[:-4] + ["--ckpt-dir", str(work / f"cpu{i}"),
                             "--ckpt-every", "1000", "--device", "cpu"]))
            tr.params.load_state_dict(init)
            tr.cfg.log_every = 1
            tr.cfg.total_steps = GNN_A_HELD  # of the 20-step schedule
            tr.fit()
            runs.append(np.array([r["loss"] for r in tr.metrics_log]))
        del tr, init
        gl, (cl, cl2) = np.array(a["losses"]), runs

        def rel(x, y):
            return np.abs(x - y) / np.abs(y)

        check(len(gl) == GNN_A_STEPS and np.all(np.isfinite(gl))
              and len(cl) == GNN_A_HELD
              and np.all(rel(gl[:GNN_A_HELD], cl) <= GNN_A_RTOL),
              f"phase 12 (a): PNA losses on the card {gl} and the CPU {cl}")
        a.update(losses_cpu=cl.tolist(), losses_cpu_again=cl2.tolist(),
                 cpu_s=(time.perf_counter() - t_cpu) / 2,
                 rel_err=rel(gl[:GNN_A_HELD], cl).tolist(),
                 cpu_spread=rel(cl2, cl).tolist())
        shutil.rmtree(work)
        log(f"phase 12 (a) {card}: pna ({a['params']} params) "
            f"{GNN_A_STEPS} steps through launch.train.main, losses "
            f"{gl[0]:.5f} -> {gl[-1]:.5f} on the card; relative difference "
            f"to the CPU's {max(a['rel_err']):.2e} over the first "
            f"{GNN_A_HELD} steps (two CPU runs: "
            f"{max(a['cpu_spread']):.2e}); card {a['wall_s']:.1f} s, CPU "
            f"{a['cpu_s']:.1f} s a run")
        for key, rec in got["b"].items():
            name, cell = key.split("/")
            gc.collect()
            torch.cuda.empty_cache()
            rec.update(gnn_compare_cell(torch, name, cell, rec))
            cpu = (f"CPU {rec['cpu_loss']}, {rec['cpu_grad_norm']} in "
                   f"{rec['cpu_grads_s']:.1f} + {rec['cpu_adamw_s']:.2f} s"
                   if "cpu_loss" in rec else "no CPU step (GNN_CARD_ONLY)")
            log(f"phase 12 (b) {card}: {name} at {cell} ({rec['params']} "
                f"params, {rec['shapes']}): step {rec['split_ms']} ms, peak "
                f"{rec['peak_bytes']} B above the phase's start; loss and "
                f"gradient norm {rec['loss']}, {rec['grad_norm']} (float64 "
                f"{rec['float64_loss']}, {rec['float64_grad_norm']}; {cpu}); "
                f"worst {rec['worst']}; card again bit-equal "
                f"{rec['card_again']['bit_equal']}, worst "
                f"{rec['card_again']['worst']}; float64 "
                f"{rec['float64_s']:.1f} s")
            gnn_check_b(name, cell, rec)
        info["c"] = gnn_ogb_cuts(torch)
        log(f"phase 12 (c) {card}: ogb_products cut for every arch: "
            + "; ".join(f"{k} {v['bytes']} B" for k, v in
                        info["c"]["cuts"].items())
            + f" against {info['c']['free_bytes']} B free")
        gc.collect()
        torch.cuda.empty_cache()
        info["finish_s"] = time.perf_counter() - t_start
        return info

    return drive, finish


# -------------------------------------------------- phase 13: sharded train

# (a): one NCCL rank, mesh (data, model) = (1, 1): each GNN's explicit-SPMD
# step at its published widths, at minibatch_lg (GCN at full_graph_sm,
# phase 9 (d)'s cell), against the unsharded step on the card
ST_A_CELLS = (("gcn-cora", "full_graph_sm"), ("pna", "minibatch_lg"),
              ("meshgraphnet", "minibatch_lg"), ("dimenet", "minibatch_lg"),
              ("dimenet-v2", "minibatch_lg"))
# (b): two gloo ranks sharing the card, mesh (1, 2), at the molecule cell,
# after (a) and (c)
ST_B_CELLS = tuple((n, "molecule") for n in ("gcn-cora", "pna",
                                              "meshgraphnet", "dimenet",
                                              "dimenet-v2"))
ST_B_RANKS = 2
# the reference's SPMD limits (tests/test_distributed.py): the largest
# relative leaf norm of the gradient difference, 1e-3 for PNA (its std
# aggregator cancels); DimeNet v2's loss within 1e-5, here relative (its
# loss is 3.2e11 at minibatch_lg) and for every arch.  The GNN steps of
# (a) and (b) run with torch's deterministic algorithms (``index_add_``
# sorted, not float atomics): with atomics two plain DimeNet losses at
# minibatch_lg lay 2.3e-6-1.1e-5 apart and the SPMD one 1.3e-5 from the
# plain one (H100, PERF.md §6), the limit's size, so atomics would
# hide what the comparison is for.  ``spread_rel`` records a second plain
# loss's distance all the same

ST_GRAD_REL = {"pna": 1e-3}
ST_GRAD_REL_DEFAULT = 1e-4
ST_LOSS_REL = 1e-5
# the LM: qwen2-1.5b at its published widths, depth 2, at phase 10's 4 x
# 4096; the DP+TP step within the reference's DP+TP limits of the
# single-device step (loss 1e-3, every parameter within rtol / atol 2e-3
# after one AdamW step at lr 1e-3).  Those limits pass whatever the
# gradient (the first AdamW step moves each element by about lr, 1e-3),
# so its gradients are held too, each leaf within ST_LM_GRAD_REL of the
# plain ones by norm, and its update within LM_ADAM_RTOL["bfloat16"]
# (0.5) of the plain update by norm (a zero gradient is 1 off, a flipped
# sign 2)
ST_LM_LAYERS = 2
# (b) runs no DP+TP step: its DTensors gather with functional collectives
# (all_gather_into_tensor), and gloo on CUDA tensors crashed the rank
# there with a segmentation fault (torch 2.11, H100, PERF.md §6) rather
# than refusing; the 4-rank DP+TP step runs in the CPU tests
ST_B_NO_LM = ("gloo's functional all-gather on CUDA tensors crashed the "
              "rank (SIGSEGV, torch 2.11); the DP+TP step on several "
              "ranks runs in tests/test_torch_sharding.py on the CPU")
ST_LM_C = (LM_BATCH, LM_SEQ)
ST_LM_OPT = dict(lr=1e-3, warmup_steps=1)
ST_LM_LOSS = 1e-3
ST_LM_PARAM = 2e-3
# (c)'s pipeline: one stage, 2 microbatches, in the compute dtype
# (bfloat16): the loss within 2e-3 (the reference's pipeline limit); its
# gradient leaves, and the DP+TP step's, within 2e-2 of their norm (bf16
# products summed in another order)
ST_PIPE_LOSS = 2e-3
ST_LM_GRAD_REL = 2e-2
ST_SEED = 13
# the times of (a) and (c): the first call, then the median and range of
# ST_WARM warm passes (plain and sharded in turn); (b) runs after them, so
# no time of (a) or (c) shares the card with its ranks
ST_WARM = 3


def st_lm_batch(torch, cfg, shape, device):
    g = torch.Generator().manual_seed(ST_SEED)
    return {k: torch.randint(0, cfg.vocab, shape, generator=g,
                             dtype=torch.int32).to(device)
            for k in ("tokens", "labels")}


def st_param_excess(torch, got: dict, want: dict) -> float:
    """The largest ``|got - want| - (atol + rtol·|want|)`` over every
    element at ``ST_LM_PARAM`` (<= 0 within the limit)."""
    worst = -float("inf")
    for k, w in want.items():
        g = got[k].to(w.device, w.dtype)
        worst = max(worst, float(torch.max(
            (g - w).abs() - (ST_LM_PARAM + ST_LM_PARAM * w.abs()))))
    return worst


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms on (warnings only where an op has
    none), restored after."""
    import warnings

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def st_gnn(torch, mesh, name: str, cell: str, profile: bool,
           warm: int = 0) -> dict:
    """One GNN's explicit-SPMD step on this rank against the unsharded
    step on the card, from the same weights (``GNN_SEED``), both under
    :func:`deterministic`: the loss, every gradient leaf, the AdamW step,
    each step's time (the first, then ``warm`` more passes) and peak
    memory, and (``profile``) the collectives the SPMD gradients ran."""
    with deterministic(torch):
        return _st_gnn(torch, mesh, name, cell, profile, warm)


def _st_gnn(torch, mesh, name: str, cell: str, profile: bool,
            warm: int) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.sharding import gnn_spmd
    from repro_torch.train.optimizer import adamw_init, adamw_update
    from repro_torch.train.trainstep import (batch_to, named_params,
                                             value_and_grad)

    v2 = name == "dimenet-v2"
    arch_name = "dimenet" if v2 else name
    arch = get_arch(arch_name)
    cfg = arch.config_for(cell)
    batch = gnn_cell_batch(torch, arch, cell, GNN_SEED)
    model = lm_model(torch, arch_name, cfg, "cuda", seed=GNN_SEED)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = named_params(model)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    out = {"cell": cell, "params": sum(p.numel() for p in params.values())}

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev[0].record()
        r = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return r, ev[0].elapsed_time(ev[1]), \
            torch.cuda.max_memory_allocated() - base

    # both steps take their batch on the card and a fresh AdamW state
    # made outside the timed span
    bp = batch_to(batch, "cuda")

    def plain(state):
        loss, grads = value_and_grad(arch.loss_fn, model, bp)
        adamw_update(params, grads, state, gnn_opt())
        return loss, grads

    state = adamw_init(params, gnn_opt())
    (loss0, g0), out["plain_ms"], out["plain_peak_bytes"] = timed(
        lambda: plain(state))
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(start)
    with torch.no_grad():  # the card's own spread: a second plain loss
        again = float(arch.loss_fn(model, bp))
    n_seg = batch["edge_src"].shape[0] if arch_name == "dimenet" \
        else batch["x"].shape[0]
    pb = (gnn_spmd.edge_shard_triplets(batch, gnn_spmd.n_shards_of(mesh))
          if v2 else gnn_spmd.pad_gnn_batch(arch_name, batch,
                                            gnn_spmd.n_shards_of(mesh),
                                            n_seg))
    bs = batch_to(pb, "cuda")
    step, spmd_cfg = gnn_spmd.make_spmd_train_step(
        arch_name, model, cfg, gnn_opt(), mesh, edge_sharded=v2)
    fields = gnn_spmd.sharded_fields(arch_name, edge_sharded=v2)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as pr:
            loss1, g1 = gnn_spmd.spmd_value_and_grad(
                arch.loss_fn, model, bs, mesh, fields)
            torch.cuda.synchronize()
        comms = Counter()
        for e in pr.events():
            if e.name == "record_param_comms" or "nccl" in e.name.lower():
                comms[e.name] += 1
        out["comm_events"] = dict(comms)
    else:
        loss1, g1 = gnn_spmd.spmd_value_and_grad(
            arch.loss_fn, model, bs, mesh, fields)
    model.load_state_dict(start)
    state = adamw_init(params, gnn_opt())
    (_, _, metrics), out["spmd_ms"], out["spmd_peak_bytes"] = timed(
        lambda: step(model, state, bs))
    out["loss"] = float(loss0)
    out["spmd_loss"] = float(loss1)
    out["step_loss"] = float(metrics["loss"])
    out["loss_rel"] = abs(out["spmd_loss"] - out["loss"]) / max(
        abs(out["loss"]), 1e-30)
    out["spread_rel"] = abs(again - out["loss"]) / max(abs(out["loss"]),
                                                       1e-30)
    out["grad_rel"] = max(float((g1[k] - g).norm()) / max(
        float(g.norm()), 1e-30) for k, g in g0.items())
    out["adam_rel"] = max(
        float((model.state_dict()[k] - p0[k]).norm()) / max(
            float((p0[k] - start[k]).norm()), 1e-30) for k in p0)
    out["grad_rel_limit"] = ST_GRAD_REL.get(arch_name, ST_GRAD_REL_DEFAULT)
    # the warm times: the plain step and the SPMD step in turn (the
    # weights drift by a step each; the times do not depend on them)
    out["plain_warm_ms"], out["spmd_warm_ms"] = [], []
    for _ in range(warm):
        for key, c, fn in (("plain_warm_ms", cfg, plain),
                           ("spmd_warm_ms", spmd_cfg,
                            lambda s: step(model, s, bs))):
            model.cfg = c
            state = adamw_init(params, gnn_opt())
            out[key].append(timed(lambda: fn(state))[1])
    return out


def st_gnn_check(what: str, name: str, row: dict) -> None:
    check(row["grad_rel"] <= row["grad_rel_limit"],
          f"{what} {name}/{row['cell']}: SPMD gradients {row['grad_rel']} "
          f"from the unsharded step's (limit {row['grad_rel_limit']})")
    check(row["loss_rel"] <= ST_LOSS_REL,
          f"{what} {name}/{row['cell']}: SPMD loss {row['spmd_loss']} "
          f"against {row['loss']}")
    check(abs(row["step_loss"] - row["spmd_loss"]) <= ST_LOSS_REL * abs(
        row["spmd_loss"]), f"{what} {name}: the step's loss "
                           f"{row['step_loss']} against {row['spmd_loss']}")
    check(row["adam_rel"] <= GNN_ADAM_RTOL,
          f"{what} {name}/{row['cell']}: SPMD AdamW step {row['adam_rel']} "
          f"of the update's norm from the unsharded one")


def st_warm(ms: list) -> str:
    """The median (range) of warm times, in ms."""
    return (f"{float(np.median(ms)):.2f} ({min(ms):.2f}-{max(ms):.2f})")


def st_host_timed(torch, fn):
    """``(fn(), host ms to a device sync, peak bytes above the start)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return (r, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def st_lm_dp_tp(torch, mesh, shape) -> dict:
    """qwen2-1.5b at depth ``ST_LM_LAYERS``: the plain step (its gradients,
    then AdamW), then from the same weights the DP+TP step
    (``sharding.lm``: DTensor parameters, moments and batch placed by the
    specs): the losses, each gradient leaf's distance from the plain one
    (the DP+TP gradients taken first, on the starting weights), the
    worst parameter's excess over ``ST_LM_PARAM``, the AdamW update's
    distance by norm a leaf, the times (the first call, then ``ST_WARM``
    warm passes) and peaks."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.sharding import lm
    from repro_torch.sharding.specs import full
    from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                             adamw_update)
    from repro_torch.train.trainstep import named_params, value_and_grad

    cfg = dataclasses.replace(get_arch(LM_ARCH).config,
                              n_layers=ST_LM_LAYERS)
    opt = OptConfig(**ST_LM_OPT)
    batch = st_lm_batch(torch, cfg, shape, "cuda")
    model = lm_model(torch, LM_ARCH, cfg, "cuda", seed=ST_SEED)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = named_params(model)
    out = {"batch": list(shape), "layers": ST_LM_LAYERS,
           "params": sum(p.numel() for p in model.parameters())}

    def plain(state):
        loss, grads = value_and_grad(transformer.loss_fn, model, batch)
        adamw_update(params, grads, state, opt)
        return loss, grads

    state = adamw_init(params, opt)
    (loss0, g0), out["plain_ms"], out["plain_peak_bytes"] = st_host_timed(
        torch, lambda: plain(state))
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    moved = {k: float((p0[k] - start[k]).norm()) for k in p0}
    out["plain_warm_ms"] = [st_host_timed(torch, lambda: plain(state))[1]
                            for _ in range(ST_WARM)]
    del state
    model.load_state_dict(start)
    del start
    specs = lm.shard_module(model, mesh)
    state = lm.shard_opt_state(adamw_init(
        {k: full(p) for k, p in model.named_parameters()}, opt), specs, mesh)
    dstep = lm.make_dp_tp_train_step(transformer.loss_fn, model, opt)
    sb = lm.shard_batch(batch, mesh)
    with implicit_replication():
        _, g1 = value_and_grad(transformer.loss_fn, model, sb)
    out["grad_rel"] = max(lm_rel(torch, full(g1.pop(k)), g) for k, g in
                          g0.items())
    del g0, g1
    (_, _, m1), out["dp_tp_ms"], out["dp_tp_peak_bytes"] = st_host_timed(
        torch, lambda: dstep(model, state, sb))
    p1 = {k: full(p).detach() for k, p in model.named_parameters()}
    out["loss"] = float(loss0)
    out["dp_tp_loss"] = float(full(m1["loss"]))
    out["param_excess"] = st_param_excess(torch, p1, p0)
    out["update_rel"] = max(float((p1[k] - p0[k]).norm()) / max(
        moved[k], 1e-30) for k in p0)
    del p0, p1
    out["dp_tp_warm_ms"] = [
        st_host_timed(torch, lambda: dstep(model, state, sb))[1]
        for _ in range(ST_WARM)]
    out["sharded_leaves"] = sum(1 for sp in specs.values() if any(sp))
    return out


def st_lm_check(what: str, row: dict) -> None:
    check(abs(row["dp_tp_loss"] - row["loss"]) <= ST_LM_LOSS,
          f"{what}: DP+TP loss {row['dp_tp_loss']} against the plain "
          f"step's {row['loss']}")
    check(row["grad_rel"] <= ST_LM_GRAD_REL,
          f"{what}: DP+TP gradients {row['grad_rel']} from the plain ones")
    check(row["param_excess"] <= 0.0,
          f"{what}: a parameter after the DP+TP step lies "
          f"{row['param_excess']} past rtol / atol {ST_LM_PARAM}")
    check(row["update_rel"] <= LM_ADAM_RTOL["bfloat16"],
          f"{what}: the DP+TP step's update {row['update_rel']} of its "
          f"norm from the plain one")


def st_pipeline(torch, shape) -> dict:
    """``pipelined_loss`` with one stage of ``("pod",)`` and 2
    microbatches against the plain loss and gradients of the same weights
    on the card; each timed cold, then ``ST_WARM`` warm passes."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.sharding.comm import mesh_scope
    from repro_torch.sharding.pipeline import pipelined_loss
    from repro_torch.train.trainstep import named_params, value_and_grad

    cfg = dataclasses.replace(get_arch(LM_ARCH).config,
                              n_layers=ST_LM_LAYERS)
    batch = st_lm_batch(torch, cfg, shape, "cuda")
    model = lm_model(torch, LM_ARCH, cfg, "cuda", seed=ST_SEED)
    params = named_params(model)
    pod = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))

    def plain():
        return value_and_grad(transformer.loss_fn, model, batch)

    def piped():
        with mesh_scope(pod):
            loss = pipelined_loss(model, batch, cfg, n_stages=1,
                                  n_microbatches=2)
            return loss.detach(), torch.autograd.grad(
                loss, list(params.values()), materialize_grads=True,
                allow_unused=True)

    (loss0, g0), plain_ms, _ = st_host_timed(torch, plain)
    (loss1, g1), pipe_ms, _ = st_host_timed(torch, piped)
    out = {"batch": list(shape), "microbatches": 2, "stages": 1,
           "loss": float(loss0), "pipe_loss": float(loss1),
           "grad_rel": max(lm_rel(torch, g, g0[k])
                           for k, g in zip(params, g1)),
           "plain_ms": plain_ms, "pipe_ms": pipe_ms,
           "plain_warm_ms": [], "pipe_warm_ms": []}
    del g0, g1
    for _ in range(ST_WARM):
        out["plain_warm_ms"].append(st_host_timed(torch, plain)[1])
        out["pipe_warm_ms"].append(st_host_timed(torch, piped)[1])
    return out


def sharded_train_rank(rank: int, world: int, device: str,
                       inputs: dict) -> dict:
    """(b)'s rank: ``ST_B_RANKS`` gloo ranks share the card, mesh (data,
    model) = (1, ``world``); each GNN's SPMD step at ``molecule``, held in
    the rank against the unsharded step on the card (numbers returned).
    The DP+TP step does not run here: ``ST_B_NO_LM``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh(device, (1, world),
                            mesh_dim_names=("data", "model"))
    out = {"gnn": {}}
    for name, cell in ST_B_CELLS:
        out["gnn"][name] = st_gnn(torch, mesh, name, cell, profile=False)
    return out


def sharded_train_phase(torch, card: str):
    """Phase 13: sharded training.  ``drive``, the launch window's whole
    content, one part after the other so that no part's times share the
    card: (a) one NCCL rank, mesh (1, 1): each GNN's SPMD step of
    ``ST_A_CELLS`` (``st_gnn``, its collectives counted with the
    profiler); (c) the DP+TP step of qwen2-1.5b at depth 2 and phase 10's
    batch (``st_lm_dp_tp``) and ``pipelined_loss`` with one stage
    (``st_pipeline``), each against the plain step on the card; (b)
    ``ST_B_RANKS`` gloo ranks sharing the card (``sharded_train_rank``).
    ``finish(out, launches)``, after the window: every limit.  Returns
    ``(drive, finish)``."""
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.sharded import free_port, spawn_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()

    def drive():
        t0 = time.perf_counter()
        out = {"held_before_phase": held, "a": {}}
        dist.init_process_group("nccl",
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            for name, cell in ST_A_CELLS:
                gc.collect()
                torch.cuda.empty_cache()
                t = time.perf_counter()
                out["a"][name] = st_gnn(torch, mesh, name, cell,
                                        profile=True, warm=ST_WARM)
                out["a"][name]["wall_s"] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            out["c"] = {"dp_tp": st_lm_dp_tp(torch, mesh, ST_LM_C)}
            gc.collect()
            torch.cuda.empty_cache()
            out["c"]["pipeline"] = st_pipeline(torch, ST_LM_C)
            out["c"]["wall_s"] = time.perf_counter() - t
        finally:
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["b"] = {"ranks": spawn_world(sharded_train_rank, ST_B_RANKS, {},
                                         "cuda", backend="gloo",
                                         timeout=600)}
        out["b"]["wall_s"] = time.perf_counter() - t
        out["drive_s"] = time.perf_counter() - t0
        return out

    def finish(got: dict, launched: dict) -> dict:
        info = {"card": card, "launches": launched, **got}
        for name, row in got["a"].items():
            st_gnn_check("phase 13 (a)", name, row)
            check(sum(row["comm_events"].values()) > 0,
                  f"phase 13 (a) {name}: the profiler saw no collective")
            log(f"phase 13 (a) {card}: {name}/{row['cell']} one NCCL rank: "
                f"loss {row['spmd_loss']} (unsharded {row['loss']}), "
                f"gradients within {row['grad_rel']:.3g}, AdamW step "
                f"within {row['adam_rel']:.3g} of its norm; step ms cold "
                f"{row['spmd_ms']:.2f}, warm {st_warm(row['spmd_warm_ms'])}"
                f" (unsharded {row['plain_ms']:.2f}, "
                f"{st_warm(row['plain_warm_ms'])}), peak "
                f"{row['spmd_peak_bytes']} B (unsharded "
                f"{row['plain_peak_bytes']} B); collectives "
                f"{row['comm_events']}")
        c = got["c"]
        st_lm_check("phase 13 (c)", c["dp_tp"])
        pipe = c["pipeline"]
        check(abs(pipe["pipe_loss"] - pipe["loss"]) <= ST_PIPE_LOSS,
              f"phase 13 (c): pipelined loss {pipe['pipe_loss']} against "
              f"{pipe['loss']}")
        check(pipe["grad_rel"] <= ST_LM_GRAD_REL,
              f"phase 13 (c): pipelined gradients {pipe['grad_rel']} from "
              f"the plain ones")
        d = c["dp_tp"]
        log(f"phase 13 (c) {card}: qwen2-1.5b depth {ST_LM_LAYERS} at "
            f"{ST_LM_C}, one NCCL rank: DP+TP loss {d['dp_tp_loss']} "
            f"(plain {d['loss']}), gradients within {d['grad_rel']:.3g}, "
            f"worst parameter {d['param_excess']:.3g} inside its limit, "
            f"update within {d['update_rel']:.3g} of its norm; step ms "
            f"first {d['dp_tp_ms']:.1f}, warm {st_warm(d['dp_tp_warm_ms'])}"
            f" (plain {d['plain_ms']:.1f}, {st_warm(d['plain_warm_ms'])}), "
            f"peak {d['dp_tp_peak_bytes']} B (plain "
            f"{d['plain_peak_bytes']} B); pipeline (1 stage, 2 "
            f"microbatches) loss {pipe['pipe_loss']} (plain "
            f"{pipe['loss']}), gradients within {pipe['grad_rel']:.3g}, "
            f"forward + backward ms cold {pipe['pipe_ms']:.1f}, warm "
            f"{st_warm(pipe['pipe_warm_ms'])} (plain {pipe['plain_ms']:.1f}"
            f", {st_warm(pipe['plain_warm_ms'])})")
        for o in got["b"]["ranks"]:
            for name, row in o["gnn"].items():
                st_gnn_check(f"phase 13 (b) rank {o['rank']}", name, row)
        b0 = got["b"]["ranks"][0]
        log(f"phase 13 (b) {card}: {ST_B_RANKS} gloo ranks share the card "
            f"(mesh (1, {ST_B_RANKS})); this verifies nothing multi-card; "
            + "; ".join(f"{n} grads within {r['grad_rel']:.3g}"
                        for n, r in b0["gnn"].items())
            + f"; {got['b']['wall_s']:.1f} s; the DP+TP step did not run on "
            f"the card here: {ST_B_NO_LM}")
        return info

    return drive, finish


# ------------------------------------------------------------------ dryrun

# phase 14 (a): the engine cells at the production size of
# src/repro_torch/configs/turbohom.py (260M vertices, 1.23B edges in 18
# edge-label blocks).  The plan's rows are the CSR rows of four labels;
# row 0, the join's label, is the last block of nbr_el, so every join probe
# searches a range past offset 2^30 (where lo + hi passes 2^31 - 1)
EC_SEED = 24
EC_ROW_LABELS = (17, 0, 5, 11)  # labels of iptr rows 0..3
EC_JOIN_EDGES = 150_000_000  # row 0's block: it starts past 2^30
EC_ROW_EDGES = 260_000_000  # rows 1-3: one edge a vertex on average
# rows 2 and 3 copy this share of their edges from row 0's, so a step's
# new vertex is often also a row-0 neighbour of the vertex it came from:
# the join's closing edges (the rest of the blocks are uniform draws)
EC_CLOSING_SHARE = 0.5
EC_LABEL_SHARE = 0.75  # vertices with bit 0 (the step filter's label) set
# start vertices: row-0 degree exactly 2, so every candidate's estimated
# load is equal and GreedyChunker deals each shard exactly `chunk` of
# them (the cell's production shape)
EC_START_DEGREE = 2
EC_SHARDS = 16  # the single-pod mesh's data-parallel shards
EC_WARM = 5
EC_OVF_CAP = 4096
# the dry run on the card machine: one cell of each family, the engine's
# two, in one subprocess
DRYRUN_CELLS = ("turbohom:triangle_q2", "turbohom:star_q4",
                "qwen2-1.5b:decode_32k", "deepseek-v2-236b:decode_32k",
                "gcn-cora:full_graph_sm:shard_map", "dlrm-rm2:serve_p99")
DRYRUN_TIMEOUT_S = 300


def engine_graph(torch, cfg, seed: int) -> dict:
    """The engine cells' replicated arrays, built on the card from
    ``seed``: ``nbr_el`` int32 [n_edges] in ``(el, src, dst)`` order (each
    block's edges drawn as uniform (src, dst) pairs, rows 2 and 3 with
    ``EC_CLOSING_SHARE`` of theirs copied from row 0's, then sorted by
    ``src · n_v + dst``), ``iptr_rows`` int32 [4, n_v + 1] (the global
    offsets of each plan row's label) and ``label_bitmap`` int32 [n_v, 1]
    (random words, bit 0 set on ``EC_LABEL_SHARE`` of the vertices)."""
    n_v, n_e, n_l = cfg.n_vertices, cfg.n_edges, cfg.n_elabels
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = {EC_ROW_LABELS[0]: EC_JOIN_EDGES}
    sizes.update({el: EC_ROW_EDGES for el in EC_ROW_LABELS[1:]})
    rest = [el for el in range(n_l) if el not in sizes]
    left = n_e - sum(sizes.values())
    for i, el in enumerate(rest):
        sizes[el] = left // len(rest) + (1 if i < left % len(rest) else 0)
    check(EC_ROW_LABELS[0] == n_l - 1 and sum(sizes.values()) == n_e,
          "phase 14: the label blocks do not tile nbr_el")
    base = {}
    off = 0
    for el in range(n_l):
        base[el] = off
        off += sizes[el]
    check(base[EC_ROW_LABELS[0]] > (1 << 30),
          "phase 14: the join's block must start past 2^30")
    nbr = torch.empty(n_e, dtype=torch.int32, device=dev)
    iptr = torch.empty((len(EC_ROW_LABELS), n_v + 1), dtype=torch.int32,
                       device=dev)
    join = {}

    def draw(n):
        return torch.randint(0, n_v, (n,), generator=gen, device=dev)

    # row 0's label first: rows 2 and 3 copy from it
    order = [EC_ROW_LABELS[0]] + [el for el in range(n_l)
                                  if el != EC_ROW_LABELS[0]]
    for el in order:
        e = sizes[el]
        copy = int(e * EC_CLOSING_SHARE) if el in EC_ROW_LABELS[2:] else 0
        src, dst = draw(e - copy), draw(e - copy)
        if copy:
            pick = torch.randint(0, join["src"].shape[0], (copy,),
                                 generator=gen, device=dev)
            src = torch.cat([src, join["src"][pick]])
            dst = torch.cat([dst, join["dst"][pick]])
            del pick
        key = torch.sort(src * n_v + dst).values
        del src, dst
        src = key // n_v
        nbr[base[el]:base[el] + e] = (key - src * n_v).to(torch.int32)
        del key
        if el == EC_ROW_LABELS[0]:
            join["src"] = src
            join["dst"] = nbr[base[el]:base[el] + e].long()
        if el in EC_ROW_LABELS:
            row = EC_ROW_LABELS.index(el)
            counts = torch.bincount(src, minlength=n_v)
            iptr[row, 0] = base[el]
            iptr[row, 1:] = (torch.cumsum(counts, 0) + base[el]).to(
                torch.int32)
            del counts
        del src
    del join
    bits = torch.randint(0, 1 << 31, (n_v, 1), generator=gen, device=dev)
    on = torch.rand((n_v, 1), generator=gen, device=dev) < EC_LABEL_SHARE
    bm = ((bits & ~1) | on.long()).to(torch.int32)
    del bits, on
    torch.cuda.synchronize()
    return {"nbr_el": nbr, "iptr_rows": iptr, "label_bitmap": bm,
            "block_bases": base, "block_sizes": sizes}


def dryrun_phase(torch, ops, ref, card: str):
    """Phase 14: the dry-run slice.  Set-up, run here: (a)'s graph on the
    card (``engine_graph``), its host copy, the start vertices dealt by
    ``GreedyChunker`` over ``EC_SHARDS`` shards, and a world-size-1 NCCL
    group and its mesh.  ``drive``, the launch window (``engine_cell``):
    each engine cell's step (``core.distributed.engine_cell``) on every
    shard's row once.  ``finish(got, launched)``, after the window: every
    shard's count and overflow against the port's CPU run of the same
    row on the host copy; one shard's step again with each
    ``bitmap_superset`` and ``edge_exists`` call recorded, each held bit
    for bit against its plain version on the card, the last step's join
    also against a numpy ``searchsorted`` in int64, and both kernels'
    true / false splits; ``EC_WARM`` warm passes of every shard's step
    (the median a shard); a chunk of the heaviest row-0 vertices at
    capacity ``EC_OVF_CAP`` must overflow on the card and on the CPU;
    the peak memory; then (b): ``repro_torch.launch.dryrun`` in a
    subprocess on ``DRYRUN_CELLS`` (single-pod mesh, fake tensors on
    ``cuda``): every record ``ok``, no kernel launched and no device
    memory allocated in it.  Returns ``(drive, finish)``."""
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.core import GreedyChunker, engine_chunk_step
    from repro_torch.core.distributed import engine_cell
    from repro_torch.launch.sharded import free_port

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    arch = get_arch("turbohom")
    cfg = arch.config
    info = {"card": card, "held_before_phase": held, "seed": EC_SEED}
    t = time.perf_counter()
    gr = engine_graph(torch, cfg, EC_SEED)
    info["graph_build_s"] = time.perf_counter() - t
    nbr, iptr, bm = gr["nbr_el"], gr["iptr_rows"], gr["label_bitmap"]
    info["graph"] = {"n_vertices": cfg.n_vertices, "n_edges": cfg.n_edges,
                     "row_labels": list(EC_ROW_LABELS),
                     "join_block_start": gr["block_bases"][EC_ROW_LABELS[0]],
                     "block_sizes": gr["block_sizes"],
                     "closing_share": EC_CLOSING_SHARE,
                     "label_share": EC_LABEL_SHARE}
    t = time.perf_counter()
    host = {k: gr[k].cpu() for k in ("nbr_el", "iptr_rows", "label_bitmap")}
    info["host_copy_s"] = time.perf_counter() - t
    deg0 = iptr[0, 1:] - iptr[0, :-1]
    pool = torch.nonzero(deg0 == EC_START_DEGREE).flatten()
    n_start = EC_SHARDS * cfg.chunk
    check(pool.shape[0] >= n_start, f"phase 14: only {pool.shape[0]} "
                                    f"vertices of row-0 degree "
                                    f"{EC_START_DEGREE}")
    pick = torch.linspace(0, pool.shape[0] - 1, n_start,
                          device="cuda").long()
    starts = pool[pick].to(torch.int32).cpu().numpy()
    heavy = torch.topk(deg0, EC_OVF_CAP).indices.to(torch.int32)
    heavy_host = heavy.cpu()
    del pool, pick
    t = time.perf_counter()
    chunks, counts, _ = GreedyChunker(EC_SHARDS).partition(
        starts, np.full(starts.max() + 1, EC_START_DEGREE, np.int64))
    info["partition_ms"] = (time.perf_counter() - t) * 1e3
    check(chunks.shape == (EC_SHARDS, cfg.chunk)
          and (counts == cfg.chunk).all(),
          f"phase 14: GreedyChunker dealt {counts.tolist()} (width "
          f"{chunks.shape[1]}), not {cfg.chunk} a shard")
    chunks_d = torch.from_numpy(chunks).cuda()
    counts_d = torch.from_numpy(counts).cuda()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    cells = {}
    for name in sorted(arch.cells):
        meta = arch.cells[name].meta
        step, args = engine_cell(mesh, cfg, meta)
        rows = meta.get("n_steps", cfg.n_steps)
        cells[name] = {"step": step, "meta": meta, "rows": rows,
                       "arg_bytes": sum(a.numel() * a.element_size()
                                        for a in args)}
    info["setup_s"] = time.perf_counter() - t0

    def run(name, s):
        c = cells[name]
        return c["step"](nbr, iptr[:c["rows"]], bm, chunks_d[s:s + 1],
                         counts_d[s:s + 1])

    def drive() -> dict:
        """Each cell's step on every shard's row, once."""
        return {name: [run(name, s) for s in range(EC_SHARDS)]
                for name in cells}

    def finish(got: dict, launched: dict) -> dict:
        try:
            return checks(got, launched)
        finally:
            dist.destroy_process_group()

    def checks(got: dict, launched: dict) -> dict:
        plains = plain_kernels(ref)
        info["launches"] = {k: int(launched[k])
                            for k in PATH_KERNELS["engine_cell"]}
        out = {}
        for name, c in cells.items():
            meta = c["meta"]
            vals = [tuple(int(x) for x in v.tolist()) for v in got[name]]
            cpu = []
            t = time.perf_counter()
            for s in range(EC_SHARDS):
                cnt, ovf = engine_chunk_step(
                    host["nbr_el"], host["iptr_rows"][:c["rows"]],
                    host["label_bitmap"], torch.from_numpy(chunks[s]),
                    int(counts[s]), cap=meta["cap"], n_steps=c["rows"])
                cpu.append((int(cnt), int(bool(ovf))))
            cpu_s = time.perf_counter() - t
            check(vals == cpu, f"phase 14 (a) {name}: the card's (count, "
                               f"overflow) a shard {vals} != the CPU's {cpu}")
            check(not any(o for _, o in vals),
                  f"phase 14 (a) {name}: a shard overflowed {vals}")

            # one shard again, each kernel call recorded
            calls = {"bitmap_superset": [], "edge_exists": []}
            orig = {k: getattr(ops, k) for k in calls}

            def rec(k):
                def wrapped(*a, **kw):
                    o = orig[k](*a, **kw)
                    calls[k].append((a, kw, o))
                    return o
                return wrapped

            for k in calls:
                setattr(ops, k, rec(k))
            try:
                again = run(name, 0).tolist()
            finally:
                for k, fn in orig.items():
                    setattr(ops, k, fn)
            check(tuple(again) == vals[0], f"phase 14 (a) {name}: shard 0 "
                                           f"again gives {again}")
            check(len(calls["bitmap_superset"]) == c["rows"]
                  and len(calls["edge_exists"]) == 1,
                  f"phase 14 (a) {name}: calls "
                  f"{ {k: len(v) for k, v in calls.items()} }")
            split = {}
            for k, lst in calls.items():
                trues = falses = 0
                for a, kw, o in lst:
                    err = max_abs_err(torch, o, plains[k](*a, **kw))
                    check(err == 0, f"phase 14 (a) {name}: {k} differs "
                                    f"from its plain version")
                    n_true = int(o.sum())
                    trues += n_true
                    falses += o.numel() - n_true
                check(trues > 0 and falses > 0,
                      f"phase 14 (a) {name}: {k} answered {trues} true, "
                      f"{falses} false")
                split[k] = {"true": trues, "false": falses}
            # the join's answers against numpy, int64 offsets
            (jn, lo, hi, tg), jkw, jo = calls["edge_exists"][0]
            lo_h, hi_h = lo.long().cpu().numpy(), hi.long().cpu().numpy()
            tg_h, jo_h = tg.long().cpu().numpy(), jo.cpu().numpy()
            nbr_h = host["nbr_el"].numpy()
            want = np.zeros_like(jo_h)
            for i in range(lo_h.shape[0]):
                seg = nbr_h[lo_h[i]:hi_h[i]].astype(np.int64)
                p = np.searchsorted(seg, tg_h[i])
                want[i] = p < seg.shape[0] and seg[p] == tg_h[i]
            check(np.array_equal(want, jo_h),
                  f"phase 14 (a) {name}: the join differs from numpy's "
                  f"searchsorted on {int((want != jo_h).sum())} probes")
            check(int(lo_h.min()) > (1 << 30) and
                  int((lo_h + hi_h).max()) > (1 << 31) - 1,
                  f"phase 14 (a) {name}: the join's ranges do not pass "
                  f"2^30 ({int(lo_h.min())})")
            # the expansion a step: each bitmap call's ids that are valid
            expansion = [int((kw["ids"] >= 0).sum())
                         for _, kw, _ in calls["bitmap_superset"]]
            # each kernel's largest call of the step: timed beside its
            # plain version and its bound (the 1.23B-word adjacency)
            kern_rows = {}
            for k in calls:
                a, kw, _ = max(calls[k], key=lambda x: x[0][0].numel()
                               if k == "edge_exists" else
                               int(x[1]["ids"].shape[0]))
                byts, nops, by = bound(torch, ref, k, a, kw)
                kern_rows[k] = {
                    "ms": time_ms(torch, lambda: getattr(ops, k)(*a, **kw)),
                    "plain_ms": time_ms(torch,
                                        lambda: plains[k](*a, **kw)),
                    "bound_ms": max(byts / PEAK_BYTES_S,
                                    nops / PEAK_OPS_S) * 1e3,
                    "bound_by": by, "probes": int(
                        (kw.get("ids") if k == "bitmap_superset"
                         else a[1]).shape[0]),
                    "table_words": int(a[0].numel())}
            del calls
            # warm passes of every shard's step (CUDA events)
            warm = []
            for s in range(EC_SHARDS):
                ms = []
                for _ in range(EC_WARM):
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                    run(name, s)
                    ev1.record()
                    ev1.synchronize()
                    ms.append(ev0.elapsed_time(ev1))
                warm.append(sorted(ms)[EC_WARM // 2])
            # the heaviest vertices at a small capacity overflow in both
            # routes
            hv = engine_chunk_step(nbr, iptr[:c["rows"]], bm, heavy,
                                   EC_OVF_CAP, cap=EC_OVF_CAP,
                                   n_steps=c["rows"])
            hc = engine_chunk_step(host["nbr_el"],
                                   host["iptr_rows"][:c["rows"]],
                                   host["label_bitmap"], heavy_host,
                                   EC_OVF_CAP, cap=EC_OVF_CAP,
                                   n_steps=c["rows"])
            check(bool(hv[1]) and bool(hc[1]) and int(hv[0]) == int(hc[0]),
                  f"phase 14 (a) {name}: the heaviest chunk at capacity "
                  f"{EC_OVF_CAP}: card {int(hv[0]), bool(hv[1])}, CPU "
                  f"{int(hc[0]), bool(hc[1])}")
            total = sum(v[0] for v in vals)
            out[name] = {
                "cap": meta["cap"], "chunk": meta["chunk"],
                "shards": EC_SHARDS, "count": total,
                "shard_counts": [v[0] for v in vals],
                "expansion_shard0": expansion, "kernel_split": split,
                "kernels": kern_rows, "warm_ms": warm,
                "warm_ms_median": sorted(warm)[EC_SHARDS // 2],
                "cpu_s": cpu_s, "arg_bytes": c["arg_bytes"]}
            log(f"phase 14 (a) {card}: {name}: {total} solutions over "
                f"{EC_SHARDS} shards of {meta['chunk']} (cap {meta['cap']}, "
                f"{c['arg_bytes'] / 1e9:.2f} GB of graph a rank), equal to "
                f"the CPU run; shard 0's expansion a step {expansion}; "
                f"split {split}; a shard step {out[name]['warm_ms_median']:.3f}"
                f" ms warm median (max {max(warm):.3f}); kernels {kern_rows}")
        peak = torch.cuda.max_memory_allocated()
        for name, c in cells.items():
            check(peak >= c["arg_bytes"], f"phase 14 (a): peak {peak} B "
                                          f"below {name}'s {c['arg_bytes']}")
        info["engine_cells"] = out
        info["peak_bytes"] = peak
        log(f"phase 14 (a) {card}: peak memory {peak / 1e9:.2f} GB; "
            f"launches in the window {info['launches']}")
        host.clear()
        gr.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the dry run in a process of its own
        t = time.perf_counter()
        out_dir = ROOT / "chiprun_out" / "dryrun"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
               "single", "--force", "--out", str(out_dir)]
        for cell in DRYRUN_CELLS:
            cmd += ["--only", cell]
        env = dict(os.environ, PYTHONPATH=str(SRC))
        res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=DRYRUN_TIMEOUT_S, cwd=str(ROOT))
        lines = res.stdout.strip().splitlines()
        check(res.returncode == 0 and lines,
              f"phase 14 (b): the dry run exited {res.returncode}: "
              f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
        summary = json.loads(lines[-1])
        recs = {}
        for cell in DRYRUN_CELLS:
            a, c = cell.split(":")[:2]
            tag = "" if cell.count(":") == 1 else f"--{cell.split(':')[2]}"
            r = json.loads((out_dir / "single" / f"{a}--{c}{tag}.json")
                           .read_text())
            check(r["status"] == "ok", f"phase 14 (b): {cell}: {r}")
            recs[cell] = {k: r[k] for k in ("flops", "bytes_accessed",
                                            "collective_bytes", "memory",
                                            "depth", "trace_s")}
        check(summary["failed"] == 0 and summary["ok"] == len(DRYRUN_CELLS),
              f"phase 14 (b): {summary}")
        check(not any(summary["launches"].values()),
              f"phase 14 (b): the dry run launched {summary['launches']}")
        check(summary["cuda_allocated"] == 0,
              f"phase 14 (b): the dry run left {summary['cuda_allocated']} B "
              f"allocated on the card")
        info["dryrun"] = {"summary": summary, "records": recs,
                          "wall_s": time.perf_counter() - t}
        log(f"phase 14 (b) {card}: dry run of {len(DRYRUN_CELLS)} cells in "
            f"a subprocess: all ok, launches {summary['launches']}, "
            f"{summary['cuda_allocated']} B allocated on the card, "
            f"{info['dryrun']['wall_s']:.1f} s")
        info["total_s"] = time.perf_counter() - t0
        log(f"phase 14: {info['total_s']:.1f} s")
        return info

    return drive, finish


def held_bytes(torch, label: str) -> dict:
    """The device memory still allocated (after a collection and with the
    allocator's cache emptied), logged under ``label``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = torch.cuda.memory_allocated()
    log(f"held {n} B {label}")
    return {"label": label, "bytes": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1000,
                    help="LUBM universities at full scale (default 1000)")
    ap.add_argument("--save-calls", type=Path, default=None,
                    help="also save the largest and smallest recorded calls "
                         "(arguments and keywords) of the kernels in "
                         "SMALLEST (torch.save) for tools/kernel_ab.py")
    args = ap.parse_args(argv)

    # large host tensors (phase 10 (b)'s CPU side: 6-10 GB of weights,
    # gradients and AdamW temporaries) on huge pages: with 4 KB pages the
    # first touch of every fresh temporary dominated an eager AdamW step
    # on an 8-core host (3.5-4x slower).  Read by torch at its first CPU
    # allocation, so set before torch is imported
    os.environ.setdefault("THP_MEM_ALLOC_ENABLE", "1")
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
    held = [held_bytes(torch, "after phase 7 (the recorded calls held)")]

    # phase 6: the engine kernels' rows on the recorded calls, then those
    # calls (and the tensors they hold) go
    table = kernel_table(torch, ops, ref, rec)
    if args.save_calls is not None:
        args.save_calls.parent.mkdir(parents=True, exist_ok=True)
        torch.save({name: {"largest": rec.calls[name][1:],
                           "smallest": rec.smallest[name][1:]}
                    for name in SMALLEST}, args.save_calls)
    hist = {p: {str(c): n for c, n in sorted(h.items())}
            for p, h in rec.cap_hist.items()}
    log(f"phase 6: expand_filter_compact calls by power-of-two capacity: "
        f"{hist}")
    rec.calls.clear()  # window's default recorder: kept, but empty
    rec.smallest.clear()
    held.append(held_bytes(torch, "after phase 6's engine rows"))
    inputs = gather_inputs(torch)
    outs = window("gather", lambda: drive_gather(torch, ops, inputs),
                  recorder=None)
    table.append(gather_row(torch, ops, ref, inputs, outs))
    del inputs, outs
    held.append(held_bytes(torch, "before phase 9 (after phase 6's "
                                  "segment_gather row)"))
    t_zoo = time.perf_counter()
    drive, finish = zoo_phase(torch, ops, ref, card)
    zoo = finish(window("zoo", drive, recorder=None),
                 by_path["zoo"]["segment_gather"])
    zoo["held_before_phase"] = held[-1]["bytes"]
    zoo["phase_s"] = time.perf_counter() - t_zoo
    del drive, finish
    table[-1]["train_batch"] = zoo["train_batch_call"]
    log(f"phase 9: {zoo['phase_s']:.1f} s")
    held.append(held_bytes(torch, "before phase 10"))
    t_lm = time.perf_counter()
    drive, finish = lm_phase(torch, card)
    lm = finish(window("lm", drive, recorder=None), by_path["lm"])
    lm["phase_s"] = time.perf_counter() - t_lm
    del drive, finish
    log(f"phase 10: {lm['phase_s']:.1f} s")
    held.append(held_bytes(torch, "before phase 11"))
    t_moe = time.perf_counter()
    drive, finish = moe_phase(torch, card)
    moe = finish(window("moe", drive, recorder=None), by_path["moe"])
    moe["phase_s"] = time.perf_counter() - t_moe
    del drive, finish
    log(f"phase 11: {moe['phase_s']:.1f} s")
    held.append(held_bytes(torch, "before phase 12"))
    t_gnn = time.perf_counter()
    drive, finish = gnn_phase(torch, card)
    gnn = finish(window("gnn", drive, recorder=None), by_path["gnn"])
    gnn["phase_s"] = time.perf_counter() - t_gnn
    del drive, finish
    log(f"phase 12: {gnn['phase_s']:.1f} s")
    held.append(held_bytes(torch, "after phase 12"))
    t_st = time.perf_counter()
    drive, finish = sharded_train_phase(torch, card)
    sharded_train = finish(window("sharded_train", drive, recorder=None),
                           by_path["sharded_train"])
    sharded_train["phase_s"] = time.perf_counter() - t_st
    del drive, finish
    log(f"phase 13: {sharded_train['phase_s']:.1f} s")
    held.append(held_bytes(torch, "after phase 13"))
    t_dry = time.perf_counter()
    drive, finish = dryrun_phase(torch, ops, ref, card)
    dryrun = finish(window("engine_cell", drive, recorder=None),
                    by_path["engine_cell"])
    dryrun["phase_s"] = time.perf_counter() - t_dry
    del drive, finish
    for row in table:
        if row["name"] in dryrun["engine_cells"]["triangle_q2"]["kernels"]:
            row["engine_cell"] = {
                name: cell["kernels"][row["name"]]
                for name, cell in dryrun["engine_cells"].items()}
    log(f"phase 14: {dryrun['phase_s']:.1f} s")

    fill_launches(table, by_path)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "parity": parity, "full": full,
              "params": params, "live": live, "serve": serve,
              "sharded": sharded, "zoo": zoo, "lm": lm, "moe": moe,
              "gnn": gnn, "sharded_train": sharded_train,
              "dryrun": dryrun, "held": held, "kernels": table,
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
