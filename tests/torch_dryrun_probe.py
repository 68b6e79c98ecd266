"""Process programs of ``test_torch_dryrun.py`` (no JAX, nothing of
``repro``): each joins a process group of its own, which a test worker
must not hold.

- ``python torch_dryrun_probe.py OUT``: on a fake world of 256 ranks
  (the single-pod mesh) runs the dry run's command line on three cells
  into ``OUT``, traces two DTensor products of known sharding, and runs
  ``analysis.perf.measure`` at depth 4 beside a direct trace at that
  depth; prints the results as one JSON line.
- :func:`engine_rank`: one rank of a ``launch.sharded.spawn_world``
  world; runs ``core.distributed.engine_cell``'s step on real tensors.
"""

from __future__ import annotations

import json
import sys

import torch


def product_records(device: str = "cpu") -> dict:
    """``[4096, 4096] @ [4096, 4096]`` in float32 twice, the operands
    placed before the trace: (a) rows over ``data`` times columns over
    ``model`` (local ``[256, 4096] @ [4096, 256]``, no collective); (b)
    the contraction over ``model`` (local ``[4096, 256] @ [256, 4096]``),
    its partial sum then replicated (one all-reduce of the ``[4096,
    4096]`` result)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.dryrun import production_mesh, trace

    mesh = production_mesh(False, device)
    meta = torch.empty((4096, 4096), device="meta")

    def built(spec_a, spec_b, gather):
        def step(a, b):
            out = a @ b
            return out.redistribute(mesh, [Replicate(), Replicate()]) \
                if gather else out

        return {"step": step, "args": (meta, meta), "place": "dtensor",
                "specs": (spec_a, spec_b)}

    return {"a": trace(built(("data", None), (None, "model"), False), mesh,
                       device),
            "b": trace(built((None, "model"), ("model", None), True), mesh,
                       device)}


def engine_rank(rank: int, world: int, device: str, inputs: dict) -> dict:
    """``engine_cell``'s step on a one-rank ``("data", "model")`` mesh,
    for each ``(cap, chunk row, count)`` case of ``inputs``: its
    ``[count, overflow]``."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.turbohom import CONFIG
    from repro_torch.core.distributed import engine_cell

    mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(CONFIG, **inputs["cfg"])
    arrays = [torch.from_numpy(inputs[k]) for k in ("nbr_el", "iptr_rows",
                                                    "label_bitmap")]
    out = []
    for cap, chunk, count in inputs["cases"]:
        step, _ = engine_cell(mesh, cfg, {"cap": cap, "chunk": len(chunk),
                                          "n_steps": 3})
        got = step(*arrays, torch.tensor([chunk], dtype=torch.int32),
                   torch.tensor([count], dtype=torch.int32))
        out.append(got.tolist())
    return {"results": out}


DRYRUN_CELLS = ("turbohom:triangle_q2", "gcn-cora:full_graph_sm",
                "dlrm-rm2:serve_p99")


def dryrun_cli(out_dir: str) -> dict:
    """``launch.dryrun``'s command line on ``DRYRUN_CELLS`` (single-pod
    mesh, fake tensors on the CPU): its exit code and its last line."""
    import contextlib
    import io

    from repro_torch.launch import dryrun

    argv = ["--mesh", "single", "--device", "cpu", "--out", out_dir]
    for c in DRYRUN_CELLS:
        argv += ["--only", c]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            dryrun.main(argv)
        except SystemExit as e:
            code = e.code
    return {"code": code, "summary": json.loads(
        buf.getvalue().strip().splitlines()[-1])}


def perf_against_trace() -> dict:
    """``perf.measure`` of qwen2-1.5b ``decode_32k`` extrapolated to 4
    layers, and the cell traced directly at 4 layers."""
    from repro_torch.analysis.perf import measure
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import production_mesh, trace

    m = measure("qwen2-1.5b", "decode_32k", device="cpu", depth=4)
    mesh = production_mesh(False, "cpu")
    t = trace(build_cell("qwen2-1.5b", "decode_32k", mesh, lm_depth=(4, 0)),
              mesh, "cpu")
    return {"measure": m, "trace": t}


if __name__ == "__main__":
    print(json.dumps({"cli": dryrun_cli(sys.argv[1]),
                      "product": product_records(),
                      "perf": perf_against_trace()}))
