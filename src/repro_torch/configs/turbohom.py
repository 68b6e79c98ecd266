"""The paper's own workload as a selectable config: the TurboHOM++ engine
serving LUBM-like query mixes.

Cells describe the distributed query step of the dry run: a chunk of
starting-vertex candidates sharded over (pod × data), the replicated graph
arrays, and a fixed 3-step triangle plan (the Q2/Q9 shape the paper's perf
study centers on) or a 4-step star.  Each rank holds a replica of the
graph: 9.08 GB for ``triangle_q2`` and 10.12 GB for ``star_q4``, so one
card runs one rank's step at its production shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.common import ArchDef, Cell, sds


@dataclass(frozen=True)
class EngineConfig:
    name: str = "turbohom"
    # synthetic graph scale for the dry-run arrays (LUBM8000-like density)
    n_vertices: int = 260_000_000
    n_edges: int = 1_230_000_000
    n_vlabels: int = 32
    n_elabels: int = 18
    cap: int = 1 << 16  # per-device binding-table capacity
    chunk: int = 1 << 14  # starting vertices per device chunk
    n_steps: int = 3  # plan length (triangle)


CONFIG = EngineConfig()

SHAPES = {
    "triangle_q2": dict(kind="engine", cap=1 << 16, chunk=1 << 14),
    "star_q4": dict(kind="engine", cap=1 << 15, chunk=1 << 14, n_steps=4),
}


def input_specs(cell: str, cfg: EngineConfig = CONFIG) -> dict:
    """One rank's arrays as ``meta`` tensors: the replicated graph (the
    ``(el, src, dst)``-sorted adjacency, a CSR indptr row a plan step, a
    label word a vertex as int32 bit patterns) and its starting chunk."""
    meta = SHAPES[cell]
    return {
        "nbr_el": sds((cfg.n_edges,)),
        "iptr_rows": sds((meta.get("n_steps", cfg.n_steps),
                          cfg.n_vertices + 1)),
        "label_bitmap": sds((cfg.n_vertices, (cfg.n_vlabels + 31) // 32),
                            torch.int32),
        "chunk": sds((meta["chunk"],)),
        "chunk_count": sds((), torch.int32),
    }


def _smoke():
    # the engine's own tests cover it; the generic harness gets a stub
    return CONFIG, {}


ARCH = ArchDef(
    name="turbohom",
    family="engine",
    config=CONFIG,
    cells={name: Cell(name, "engine", dict(meta))
           for name, meta in SHAPES.items()},
    input_specs=input_specs,
    smoke=_smoke,
    notes="the paper's engine as a distributed workload; its step is "
          "core.distributed.engine_cell",
)
