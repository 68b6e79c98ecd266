"""A local world of ranks for sharded query runs.

:func:`spawn_ranks` starts every rank of a ``torch.distributed`` world on
this host, one ``torch.multiprocessing`` process a rank.  Each runs
:func:`run_rank`: it builds a ``DeviceMesh`` with the reference's axis
names, holds its own replica of the graph, and answers every plan's count
through :func:`repro_torch.core.distributed.run_sharded`.
:func:`spawn_world` runs any module-level function on every rank of such
a world (the sharded training checks).
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


def _world_rank(rank: int, fn, world: int, device: str, backend: str,
                init_method: str, timeout: float, inputs, results) -> None:
    """One rank of :func:`spawn_world`: join the process group, put
    ``{"rank": rank, **fn(rank, world, device, inputs)}`` on ``results``,
    leave the group."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(RANK_THREADS)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout))
    try:
        results.put({"rank": rank, **fn(rank, world, device, inputs)})
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world: int, inputs, device: str,
                backend: str | None = None,
                timeout: float = 420.0) -> list[dict]:
    """Run ``fn(rank, world, device, inputs) -> dict`` on every rank of a
    ``world``-rank world on this host (``fn`` a module-level function, so
    a spawned process can import it) and return the dicts in rank order,
    each with its ``"rank"``.  NCCL serves ``"cuda"`` and gloo ``"cpu"``
    unless ``backend`` says otherwise.  The first rank to fail ends the
    world (``torch.multiprocessing`` re-raises its traceback); a world
    still running after ``timeout`` seconds is killed."""
    import torch.multiprocessing as mp

    backend = backend or ("nccl" if device == "cuda" else "gloo")
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _world_rank, args=(fn, world, device, backend,
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


def run_rank(rank: int, world: int, device: str, inputs: dict) -> dict:
    """One rank of :func:`spawn_ranks`: build the mesh and return every
    plan's ``run_sharded`` count (and its time).  ``inputs`` holds the
    mesh shape, the backend, and the graph's and the plans' plain fields
    (``repro_torch.convert``), so every rank builds its own replica."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import graph_from_arrays, plan_from_fields
    from repro_torch.core import ExecOpts, Executor, run_sharded

    mesh_shape = inputs["mesh"]
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
    return {"counts": counts, "ms": ms, "mesh": list(mesh_shape),
            "backend": inputs["backend"], "device": device}


def spawn_ranks(g, plans: dict, world: int, mesh_shape: tuple, device: str,
                backend: str | None = None,
                timeout: float = 420.0) -> list[dict]:
    """Every rank's :func:`run_rank` result, in rank order (see
    :func:`spawn_world`).  ``g`` and ``plans`` may be the port's objects or
    any with the same fields."""
    from repro_torch.convert import graph_fields, plan_fields

    backend = backend or ("nccl" if device == "cuda" else "gloo")
    inputs = {"graph": graph_fields(g), "mesh": tuple(mesh_shape),
              "backend": backend,
              "plans": {k: plan_fields(p) for k, p in plans.items()}}
    return spawn_world(run_rank, world, inputs, device, backend, timeout)
