"""Multi-pod dry run: trace EVERY (architecture × input shape) over the
production meshes and record its cost a rank, its collective bytes and its
memory.

The mesh is a fake process group (``FakeStore`` with the ``"fake"``
backend: collectives return at once and move nothing) of 256 ranks
(``single``: ``(data 16, model 16)``) or 512 (``multi``: ``(pod 2, data
16, model 16)``), joined by this process as rank 0.  The cell's step runs
once on rank 0 under ``FakeTensorMode``: its tensors have shapes, dtypes
and devices (``cuda`` unless ``--device cpu``; no card is needed) and no
storage, so billion-edge graphs and 236B-parameter models cost nothing.
A dispatch-mode counter (:class:`Counter`) sees every local op and
collective and records

- ``flops``: matmul-class ops by ``torch.utils.flop_counter``'s formulas,
  one op an output element for pointwise ops and one an input element for
  reductions, on the local shards (DTensor's own ops, on global shapes,
  are not counted: only the local ops they run);
- ``bytes_accessed``: each compute op's inputs read once and outputs
  written once; gathers and scatters (``index``, ``index_select``,
  ``gather``, ``embedding``, ``index_put_``, ``index_add_``, ``scatter*``)
  by the elements they touch plus their indices, as XLA's cost analysis
  charges them; a hand-written kernel (an operator of the ``repro_torch``
  namespace, which the fake mode answers with its shape function) by its
  model in ``analysis.roofline`` (``op_call_cost``);
- ``collective_bytes``: the output bytes of each collective under the
  reference's op names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``) and their ``total``;
- ``memory``: ``argument_size_in_bytes`` (the step's inputs, local shards),
  ``output_size_in_bytes`` (what it returns that is not an input) and
  ``temp_size_in_bytes`` (the peak of the storages the step made that were
  alive at once).

LM cells are traced at two small depths and extrapolated to the full
depth (``lm_depth``, as ``analysis.perf`` does): every layer is the same
module, so in eager torch this is exact.  Each record's ``depth`` says
``"full"`` or ``"extrapolated"``.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell train_4k

Results: ``runs/dryrun/<mesh>/<arch>--<cell>.json`` (existing cells are
skipped, so an interrupted sweep resumes).  Run it in a process of its
own: it holds the default process group.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "all-gather", "broadcast_": "all-gather",
}
OP_NAMES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
# ops that gather rows: charged by the elements they read plus indices
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# ops that scatter rows: charged by the elements they write plus indices
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_add",
             "index_add_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_copy", "index_copy_", "index_fill", "index_fill_",
             "masked_scatter"}
# reductions: one op an input element
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
               "linalg_vector_norm", "cumsum", "logsumexp", "all", "any",
               "_softmax", "_log_softmax", "var", "var_mean", "std"}
# ops that move no data or only describe a tensor
_FREE = {"detach", "alias", "empty", "empty_strided", "empty_like",
         "new_empty", "new_empty_strided", "lift_fresh", "set_",
         "resize_", "_local_scalar_dense", "wait_tensor", "device",
         "layout", "dim", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "record_stream"}


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts the local ops of a traced step (see the module's docstring);
    an op on a DTensor is let through to DTensor, whose local ops come back
    here.  Ops on ``meta`` tensors (DTensor's sharding propagation) are not
    counted."""

    def __init__(self, exclude=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: dict[str, float] = {}
        self.kernel_calls: dict[str, int] = {}
        self.live: dict[int, tuple] = {}  # storage key -> (weakref, bytes)
        self.live_bytes = 0
        self.peak = 0
        # storages made before the step (its arguments): not temporaries
        self.exclude = set(exclude)
        self.muted = 0
        self._patched: list = []

    def _mute(self, cls, name: str) -> None:
        """While ``cls.name`` runs, count nothing, and leave the fake mode:
        DTensor's sharding propagation runs the op on placeholders of the
        global shapes (in a fake mode of its own), on a cache miss only;
        it and a strided shard's layout read index tensors they make to
        the host."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        orig = getattr(cls, name, None)
        if orig is None:
            return
        counter = self

        def muted(*a, **k):
            counter.muted += 1
            try:
                with unset_fake_temporarily():
                    return orig(*a, **k)
            finally:
                counter.muted -= 1

        setattr(cls, name, muted)
        self._patched.append((cls, name, orig))

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        from torch.distributed.tensor import placement_types

        for name in ("_propagate_tensor_meta_non_cached",
                     "propagate_op_sharding_non_cached"):
            self._mute(ShardingPropagator, name)
        # a strided shard's offsets: an index tensor it reads to the host
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None:
            self._mute(strided, "local_shard_size_and_offset")
        return super().__enter__()

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._patched):
            setattr(cls, name, orig)
        self._patched.clear()
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------

    @staticmethod
    def _key(t: torch.Tensor):
        from torch.multiprocessing.reductions import StorageWeakRef

        ref = StorageWeakRef(t.untyped_storage())
        return ref.cdata, ref

    def _track(self, out) -> None:
        for t in _tensors(out):
            if t.device.type == "meta":
                continue
            key, ref = self._key(t)
            if key in self.live or key in self.exclude:
                continue
            nb = t.untyped_storage().nbytes()
            self.live[key] = (ref, nb)
            self.live_bytes += nb
        for key in [k for k, (r, _) in self.live.items() if r.expired()]:
            self.live_bytes -= self.live.pop(key)[1]
        self.peak = max(self.peak, self.live_bytes)

    # -- cost --------------------------------------------------------------

    def _cost(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        from repro_torch.analysis.roofline import op_call_cost

        name = func._opname
        ns = func.namespace
        if ns == "repro_torch":  # a hand-written kernel, by its model
            kernel, c = op_call_cost(name, args)
            self.flops += c["flops"]
            self.bytes += c["bytes"]
            self.kernel_calls[kernel] = self.kernel_calls.get(kernel, 0) + 1
            return
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            op = COLLECTIVES.get(name)
            if op is not None:
                moved = out if ns == "_c10d_functional" else args[0]
                b = float(sum(_nbytes(t) for t in _tensors(moved)))
                self.coll[op] = self.coll.get(op, 0.0) + b
            return
        if name in _FREE or func.is_view:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += float(sum(t.numel() for t in outs))
        elif name in _REDUCTIONS:
            self.flops += float(sum(t.numel() for t in ins))
        if name in _GATHERS:
            # the rows read and written, and the indices
            self.bytes += (2.0 * sum(_nbytes(t) for t in outs)
                           + sum(_nbytes(t) for t in ins[1:]))
        elif name in _SCATTERS:
            # the values (the last tensor argument) read, and the rows
            # they meet read and written; the indices between
            self.bytes += (3.0 * _nbytes(ins[-1])
                           + sum(_nbytes(t) for t in ins[1:-1]))
        else:
            self.bytes += float(sum(_nbytes(t) for t in ins)
                                + sum(_nbytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.muted or any(t.device.type == "meta"
                             for t in _tensors((args, kwargs))):
            return out
        self._cost(func, args, kwargs, out)
        self._track(out)
        return out


# ---------------------------------------------------------------------------
# world, arguments
# ---------------------------------------------------------------------------


def fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (leaving a
    default group of another size first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool, device: str):
    """The production mesh on a fake world of its size."""
    from repro_torch.launch.mesh import make_production_mesh

    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device=device)


def _local_shape(shape, spec, mesh) -> tuple:
    from repro_torch.sharding.specs import _axis_size

    out = list(shape)
    for d, axis in enumerate(tuple(spec or ())):
        if axis is not None:
            out[d] //= _axis_size(mesh, axis)
    return tuple(out)


def _fake_like(t: torch.Tensor, device, shape=None):
    """A fake tensor of ``t``'s dtype (``shape`` or ``t``'s) on ``device``
    (call under the fake mode)."""
    return torch.empty(tuple(t.shape) if shape is None else shape,
                       dtype=t.dtype, device=device)


def materialize(built: dict, mesh, device):
    """The cell's arguments as fake tensors on ``device`` (call under the
    fake mode), placed as ``built["place"]`` says:

    - ``"dtensor"``: a module's parameters, an optimizer state's moments
      and a batch's leaves become DTensors by ``built["specs"]``;
    - ``"local"``: each leaf is this rank's local shard of its spec (a
      module's parameters keep their full shapes: the families that place
      so replicate them or shard them themselves);
    - ``None``: every leaf whole;

    and a leaf named in ``built["consts"]`` becomes that Python int (a
    fake tensor has no value to read)."""
    from torch import nn

    from repro_torch.sharding.specs import distribute
    from repro_torch.train.optimizer import AdamWState

    place = built.get("place")
    specs = built.get("specs") or (None,) * len(built["args"])
    consts = built.get("consts", {})

    def leaf(name, t, spec):
        if name in consts:  # read by the step as a Python value
            return consts[name]
        if place == "dtensor":
            return distribute(_fake_like(t, device), mesh, spec or ())
        if place == "local" and spec:
            return _fake_like(t, device, _local_shape(t.shape, spec, mesh))
        return _fake_like(t, device)

    def tree(x, spec):
        if not isinstance(x, dict):
            return leaf("", x, spec)
        out = {}
        for k, v in x.items():
            sp = None if spec is None else spec.get(k)
            out[k] = tree(v, sp) if isinstance(v, dict) else leaf(k, v, sp)
        return out

    out = []
    for arg, spec in zip(built["args"], specs):
        if isinstance(arg, nn.Module):
            arg.to_empty(device=device)
            if place == "dtensor":
                from repro_torch.sharding.lm import _set_param

                for name, p in list(arg.named_parameters()):
                    _set_param(arg, name, distribute(p.detach(), mesh,
                                                     spec[name]))
            elif place == "local" and spec:
                from repro_torch.sharding.lm import _set_param

                for name, p in list(arg.named_parameters()):
                    shape = _local_shape(p.shape, spec[name], mesh)
                    if shape != tuple(p.shape):
                        _set_param(arg, name, _fake_like(p, device, shape))
            out.append(arg)
        elif isinstance(arg, AdamWState):
            out.append(AdamWState(
                leaf("step", arg.step, ()),
                tree(arg.mu, None if spec is None else spec.mu),
                tree(arg.nu, None if spec is None else spec.nu),
                None if arg.err is None else tree(
                    arg.err, None if spec is None else spec.err)))
        else:
            out.append(tree(arg, spec))
    return tuple(out)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def _local_bytes(tree) -> dict[int, int]:
    """Storage key -> bytes of every local tensor in ``tree`` (a DTensor by
    its local shard; a module by its parameters)."""
    from torch import nn
    from torch.distributed.tensor import DTensor

    out = {}

    def add(t):
        if isinstance(t, DTensor):
            t = t._local_tensor
        key, _ = Counter._key(t)
        out[key] = t.untyped_storage().nbytes()

    for x in tree:
        if isinstance(x, nn.Module):
            for p in x.parameters():
                add(p)
            continue
        from torch.utils._pytree import tree_leaves

        for t in tree_leaves(x):
            if isinstance(t, torch.Tensor):
                add(t)
    return out


def trace(built: dict, mesh, device: str = "cuda") -> dict:
    """Run the built cell's step once on fake tensors: ``{flops,
    bytes_accessed, collective_bytes, memory, kernel_calls, trace_s}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = materialize(built, mesh, torch.device(device))
        arg_bytes = _local_bytes(args)
        counter = Counter(exclude=arg_bytes)
        with counter:
            out = built["step"](*args)
        out_bytes = _local_bytes((out,)) if out is not None else {}
    coll = {k: counter.coll.get(k, 0.0) for k in OP_NAMES
            if k in counter.coll}
    coll["total"] = sum(coll.values())
    return {
        "flops": counter.flops,
        "bytes_accessed": counter.bytes,
        "collective_bytes": coll,
        "memory": {
            "argument_size_in_bytes": sum(arg_bytes.values()),
            "output_size_in_bytes": sum(v for k, v in out_bytes.items()
                                        if k not in arg_bytes),
            "temp_size_in_bytes": counter.peak,
        },
        "kernel_calls": counter.kernel_calls,
        "trace_s": time.time() - t0,
    }


def _lm_depths(cfg, depth: int) -> tuple[tuple, tuple, int]:
    """The two depths an LM cell is traced at and the multiple of their
    difference that extends the first to ``depth`` layers: ``(1, 0)`` and
    ``(2, 0)`` for a dense LM; ``(d, 1)`` and ``(d, 2)`` for an MoE LM
    (``d = min(1, first_dense_layers)``; a dense prefix is counted with
    the fixed part, as the reference's ``perf`` counts it)."""
    if cfg.moe is None:
        return (1, 0), (2, 0), depth - 1
    nd = min(1, cfg.moe.first_dense_layers)
    return (nd, 1), (nd, 2), depth - nd - 1


def _extrapolate(a: dict, b: dict, n: int) -> dict:
    """``a + n · (b - a)`` for every count of two traces."""
    def lin(x, y):
        return x + n * (y - x)

    coll = {k: lin(a["collective_bytes"].get(k, 0.0),
                   b["collective_bytes"].get(k, 0.0))
            for k in set(a["collective_bytes"]) | set(b["collective_bytes"])}
    mem = {k: lin(a["memory"][k], b["memory"][k]) for k in a["memory"]}
    calls = {k: lin(a["kernel_calls"].get(k, 0), b["kernel_calls"].get(k, 0))
             for k in set(a["kernel_calls"]) | set(b["kernel_calls"])}
    return {"flops": lin(a["flops"], b["flops"]),
            "bytes_accessed": lin(a["bytes_accessed"], b["bytes_accessed"]),
            "collective_bytes": coll, "memory": mem, "kernel_calls": calls,
            "trace_s": a["trace_s"] + b["trace_s"]}


def trace_cell(arch_name: str, cell_name: str, mesh, *,
               profile: str = "baseline", device: str = "cuda",
               depth: int | None = None) -> dict:
    """A cell's trace on ``mesh``: an LM cell at two depths, extrapolated
    to ``depth`` layers (its config's by default), anything else as it
    is; the record's ``depth`` says which."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell

    arch = get_arch(arch_name)
    if arch.family != "lm":
        rec = trace(build_cell(arch_name, cell_name, mesh, profile=profile),
                    mesh, device)
        rec["depth"] = "full"
        return rec
    d1, d2, n = _lm_depths(arch.config, depth or arch.config.n_layers)
    a = trace(build_cell(arch_name, cell_name, mesh, lm_depth=d1,
                         profile=profile), mesh, device)
    b = trace(build_cell(arch_name, cell_name, mesh, lm_depth=d2,
                         profile=profile), mesh, device)
    rec = _extrapolate(a, b, n)
    rec["depth"] = "extrapolated"
    rec["traced_depths"] = [list(d1), list(d2)]
    return rec


def run_cell(arch_name: str, cell_name: str, mesh_name: str, out_dir: Path,
             force: bool = False, device: str = "cuda",
             profile: str = "baseline") -> dict:
    tag = "" if profile == "baseline" else f"--{profile}"
    out_path = out_dir / f"{arch_name}--{cell_name}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    from repro_torch.sharding.specs import mesh_dims

    mesh = production_mesh(mesh_name == "multi", device)
    rec = {"arch": arch_name, "cell": cell_name, "mesh": mesh_name,
           "profile": profile, "device": device,
           "mesh_shape": mesh_dims(mesh), "status": "error"}
    t0 = time.time()
    try:
        rec.update(trace_cell(arch_name, cell_name, mesh, profile=profile,
                              device=device))
        rec["status"] = "ok"
        print(f"[dryrun] {mesh_name}/{arch_name}/{cell_name}: OK  "
              f"flops={rec['flops']:.3e} "
              f"coll={rec['collective_bytes']['total']:.3e}B "
              f"trace={time.time() - t0:.1f}s", flush=True)
        print(f"  memory: {rec['memory']}", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {mesh_name}/{arch_name}/{cell_name}: FAIL {e}",
              flush=True)
    rec["trace_s"] = time.time() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    from repro_torch.configs import all_archs, get_arch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--cell", default=None, help="one cell (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors lie on")
    ap.add_argument("--profile", default="baseline")
    ap.add_argument("--only", action="append", default=[],
                    metavar="ARCH:CELL[:PROFILE]",
                    help="trace just these cells (repeatable; instead of "
                         "--arch / --cell)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.only:
        todo = [tuple(o.split(":")) + ((args.profile,) if o.count(":") == 1
                                       else ()) for o in args.only]
    else:
        todo = [(a, c, args.profile)
                for a in ([args.arch] if args.arch else all_archs())
                for c in ([args.cell] if args.cell
                          else sorted(get_arch(a).cells))]
    n_ok = n_fail = 0
    t0 = time.time()
    for mesh_name in meshes:
        for arch_name, cell_name, profile in todo:
            rec = run_cell(arch_name, cell_name, mesh_name,
                           Path(args.out) / mesh_name, force=args.force,
                           device=args.device, profile=profile)
            if rec["status"] == "ok":
                n_ok += 1
            else:
                n_fail += 1
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed in "
          f"{time.time() - t0:.1f}s", flush=True)
    # what the trace left on the device: no kernel launch, no allocation
    from repro_torch.kernels import ops

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    print(json.dumps({"ok": n_ok, "failed": n_fail,
                      "seconds": time.time() - t0,
                      "launches": dict(ops.launches),
                      "cuda_allocated": (torch.cuda.memory_allocated()
                                         if on_card else 0)}), flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
