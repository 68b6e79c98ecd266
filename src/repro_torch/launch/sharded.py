"""A local world of ranks for sharded query runs.

:func:`spawn_ranks` starts every rank of a ``torch.distributed`` world on
this host, one ``torch.multiprocessing`` process a rank.  Each runs
:func:`run_rank`: it joins the process group, builds a ``DeviceMesh`` with
the reference's axis names, holds its own replica of the graph, and answers
every plan's count through :func:`repro_torch.core.distributed.run_sharded`.
NCCL serves a CUDA mesh and gloo a CPU mesh; ``backend="gloo"`` on CUDA lets
several ranks share one card (NCCL refuses two ranks on one GPU).  Eight
ranks of a ``(2, 2, 2)`` mesh on the CPU::

    outs = spawn_ranks(g, {"Q9": plan}, 8, (2, 2, 2), "cpu")
"""

from __future__ import annotations

import socket
import time
from datetime import timedelta

AXES = ("pod", "data", "model")
# torch threads a rank: the ranks of a world share this host's cores
RANK_THREADS = 1


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank(rank: int, world: int, mesh_shape: tuple, device: str,
             backend: str, init_method: str, timeout: float, inputs: dict,
             results) -> None:
    """One rank: join the process group, build the mesh and put every
    plan's ``run_sharded`` count (and its time) on ``results``.  ``inputs``
    holds the graph's and the plans' plain fields (``repro_torch.convert``),
    so every rank builds its own replica; a collective waits at most
    ``timeout`` seconds."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import graph_from_arrays, plan_from_fields
    from repro_torch.core import ExecOpts, Executor, run_sharded

    torch.set_num_threads(RANK_THREADS)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout))
    try:
        mesh = init_device_mesh(device, mesh_shape,
                                mesh_dim_names=AXES[:len(mesh_shape)])
        ex = Executor(graph_from_arrays(inputs["graph"]), ExecOpts(),
                      device=device)
        counts, ms = {}, {}
        for name, fields in inputs["plans"].items():
            plan = plan_from_fields(fields)
            t0 = time.perf_counter()
            counts[name] = run_sharded(ex, plan, mesh)
            ms[name] = (time.perf_counter() - t0) * 1e3
        results.put({"rank": rank, "counts": counts, "ms": ms,
                     "mesh": list(mesh_shape), "backend": backend,
                     "device": device})
    finally:
        dist.destroy_process_group()


def spawn_ranks(g, plans: dict, world: int, mesh_shape: tuple, device: str,
                backend: str | None = None,
                timeout: float = 420.0) -> list[dict]:
    """Run every rank of a ``world``-rank world on this host and return
    their results in rank order.  ``g`` and ``plans`` may be the port's
    objects or any with the same fields.  The first rank to fail ends the
    world (``torch.multiprocessing`` re-raises its traceback); a world
    still running after ``timeout`` seconds is killed."""
    import torch.multiprocessing as mp

    from repro_torch.convert import graph_fields, plan_fields

    backend = backend or ("nccl" if device == "cuda" else "gloo")
    inputs = {"graph": graph_fields(g),
              "plans": {k: plan_fields(p) for k, p in plans.items()}}
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        run_rank, args=(world, tuple(mesh_shape), device, backend,
                        f"tcp://127.0.0.1:{free_port()}", timeout, inputs,
                        results),
        nprocs=world, join=False, start_method="spawn")
    outs = []
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            while not results.empty():  # no rank may block on a full pipe
                outs.append(results.get())
            if time.monotonic() > deadline:
                raise TimeoutError(f"a {world}-rank world still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    while not results.empty():
        outs.append(results.get())
    return sorted(outs, key=lambda o: o["rank"])
