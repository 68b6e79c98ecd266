"""Production mesh construction on a ``torch.distributed`` ``DeviceMesh``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh needs one rank a device, so the caller joins a
process group of the mesh's size first (``init_process_group``); the
production shapes (256 and 512 ranks) form in one process on a fake
process group (``torch.testing._internal.distributed.fake_pg.FakeStore``
with the ``"fake"`` backend), as the dry run builds them.

Axis semantics, as the reference's:
  pod    — inter-pod data parallelism (and the pipeline axis when PP is on)
  data   — within-pod data parallelism + ZeRO sharding of params/optimizer
  model  — tensor/expert parallelism (and sequence parallelism for long
           activations)

Meshes live on the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations


def _mesh(device: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def elastic_shape(model_parallelism: int, world: int) -> tuple[int, int]:
    """``(data, model)`` for ``world`` ranks: ``model`` shrinks from
    ``model_parallelism`` until it divides the world."""
    model = min(model_parallelism, world)
    while world % model:
        model -= 1
    return world // model, model


def make_elastic_mesh(model_parallelism: int = 16, world: int | None = None,
                      device: str = "cuda"):
    """Elastic variant: whatever ranks are alive (``world``, by default
    the process group's size), shaped ``(data, model)``.

    Used by checkpoint restore after a topology change: the data-parallel
    size follows the live rank count (model parallelism is fixed by the
    parameter sharding layout)."""
    import torch.distributed as dist

    world = world if world is not None else dist.get_world_size()
    return _mesh(device, elastic_shape(model_parallelism, world),
                 ("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod folds into data parallelism)."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)
