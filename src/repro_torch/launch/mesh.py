"""Device meshes (counterpart of ``repro.launch.mesh``) over
``torch.distributed.device_mesh.init_device_mesh``.

Single pod:  (16, 16)      axes ("data", "model")
Multi pod:   (2, 16, 16)   axes ("pod", "data", "model")

A mesh needs a process group of as many ranks as it has devices.
:func:`make_mesh` starts a one-rank group itself for a mesh of one device
(from an in-process store: no network, no environment variables);
anything larger runs over the group the caller started
(``torch.distributed.init_process_group``, one process per device, or a
``"fake"`` group for specs and dry runs).  Meshes default to the card,
as every entry point of the port does; ``device_type="cpu"`` builds them
over ``gloo``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["make_production_mesh", "make_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` (tests use
    small ones, e.g. (2, 2)).  Raises ``ValueError`` when the mesh's size
    is not the process group's world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh was requested but CUDA is not "
                           "available; pass device_type='cpu' to build it "
                           "on the CPU")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {shape} has {n} devices but no process group is "
                f"initialised (world size 1); start one with "
                f"torch.distributed.init_process_group")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    elif n != dist.get_world_size():
        raise ValueError(f"mesh {shape} has {n} devices but the process "
                         f"group's world size is {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the caller's process group of 256 (or,
    ``multi_pod``, 512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)
