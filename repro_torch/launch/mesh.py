"""Production mesh construction (counterpart of ``repro.launch.mesh``).

Single pod: 16×16 = 256 devices, axes (data, model).
Multi-pod:  2×16×16 = 512 devices, axes (pod, data, model): the "pod"
axis is pure data parallelism, where the ring schedule and gradient
compression of ``distributed/collectives.py`` apply.

:func:`make_production_mesh` is a function, never a module constant, so
importing this module touches no process group or device; callers opt
in.  It needs the process group initialized over the whole world
(``torch.distributed.init_process_group``, one process per card).
"""

from __future__ import annotations

import math
from typing import Tuple

__all__ = ["make_production_mesh", "mesh_shape", "require_devices"]


def mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def require_devices(n: int) -> int:
    """The world size when it holds at least ``n`` ranks; else
    ``RuntimeError``.  The world is the initialized process group's, or
    without one the cards this process sees."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, what = dist.get_world_size(), "ranks in the process group"
    else:
        world, what = torch.cuda.device_count(), "CUDA devices and no process group"
    if world < n:
        raise RuntimeError(
            f"need {n} devices, found {world} {what}: start one process per "
            "card (torchrun) and call torch.distributed.init_process_group "
            "before building the production mesh"
        )
    return world


def make_production_mesh(*, multi_pod: bool = False):
    """The target mesh, a ``DeviceMesh`` of CUDA devices: (16, 16)
    single-pod or (2, 16, 16) multi-pod."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = mesh_shape(multi_pod)
    require_devices(math.prod(shape))
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)
