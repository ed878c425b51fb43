"""Device meshes over the process group's ranks.

The port of ``repro/launch/mesh.py``.  Functions, not module constants:
importing this module touches no process group.  Each returns a
:class:`torch.distributed.device_mesh.DeviceMesh` over the world that
``torch.distributed`` was initialized with (``torchrun`` sets it up, or
the caller's ``init_process_group``); ranks are laid out row-major, so a
model group is ``model`` consecutive ranks.  The device type is CUDA
where a card is visible, else the CPU (gloo).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"a {shape} mesh needs {n} ranks; the process group has "
            f"{world}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)`` with ``multi_pod``; raises unless the world has exactly that
    many ranks.  ``model`` carries tensor and expert parallelism;
    ``data`` data parallelism; ``pod`` only data-parallel gradients."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names)


def make_host_mesh(model: int = 1):
    """A ``(world // model, model)`` ``(data, model)`` mesh over the
    current world (tests, examples, ``launch.serve --mesh``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model:
        raise ValueError(f"model={model} does not divide the world of "
                         f"{world} ranks")
    return _mesh((world // model, model), ("data", "model"))
