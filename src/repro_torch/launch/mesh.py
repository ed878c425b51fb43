"""Device meshes over the process group's ranks.

The port of ``repro/launch/mesh.py``.  Functions, not module constants:
importing this module touches no process group.  Each returns a
:class:`torch.distributed.device_mesh.DeviceMesh` over the world that
``torch.distributed`` was initialized with (``torchrun`` sets it up, or
the caller's ``init_process_group``); ranks are laid out row-major, so a
model group is ``model`` consecutive ranks.  The device type is the
caller's (``cuda`` by default: entry points run on the card); a CUDA
mesh without a card raises, it never becomes a CPU one.
:func:`init_mesh` sets up the process group and mesh of a launcher's
``--mesh DxM`` under ``torchrun``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _device_type(device_type: str) -> str:
    kind = torch.device(device_type).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for and no card is "
                           "visible; pass device_type='cpu' for a gloo "
                           "mesh of CPU ranks")
    return kind


def _mesh(shape, names, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"a {shape} mesh needs {n} ranks; the process group has "
            f"{world}")
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)`` with ``multi_pod``; raises unless the world has exactly that
    many ranks.  ``model`` carries tensor and expert parallelism;
    ``data`` data parallelism; ``pod`` only data-parallel gradients."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ``(world // model, model)`` ``(data, model)`` mesh over the
    current world (tests, examples, the launchers' ``--mesh``), of
    ``device_type``'s ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model:
        raise ValueError(f"model={model} does not divide the world of "
                         f"{world} ranks")
    return _mesh((world // model, model), ("data", "model"), device_type)


def init_mesh(spec: str, device: str):
    """The process group and ``(data, model)`` mesh of ``--mesh DxM``,
    and the rank's device: the rank, world and rendezvous come from
    ``torchrun``'s environment; NCCL with one card a rank
    (``LOCAL_RANK``), gloo on the CPU.  ``spec`` may be ``"xM"`` (the
    model degree alone, ``--model-parallel M``): the data degree is
    then the world over ``M``."""
    d_s, m_s = spec.lower().split("x")
    m = int(m_s)
    if "RANK" not in os.environ:
        raise SystemExit(f"--mesh {spec}: run under torchrun "
                         f"--nproc-per-node {int(d_s or 1) * m}")
    if torch.device(device).type == "cuda":
        _device_type("cuda")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(torch.device(device))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend)
    world = dist.get_world_size()
    d = int(d_s) if d_s else world // m
    if world != d * m:
        raise SystemExit(f"--mesh {spec} needs {d * m} ranks, torchrun "
                         f"started {world}")
    return make_host_mesh(model=m, device_type=torch.device(device).type), \
        device
