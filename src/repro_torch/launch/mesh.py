"""Mesh construction (the port of ``repro.launch.mesh``). Functions only:
importing this module touches no device and no process group.

``make_production_mesh`` and ``make_local_mesh`` give a ``DeviceMesh`` over
the process group the caller started (``torch.distributed.
init_process_group``); ``production_mesh_shape`` and ``local_mesh_shape``
give the same meshes' names and sizes alone, for the sharding rules."""
from __future__ import annotations

import math

from ..parallel.sharding import MeshShape


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` across two pods: the reference's production meshes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def local_mesh_shape(world_size: int) -> MeshShape:
    """(world_size, 1) ``("data", "model")``."""
    return MeshShape(("data", "model"), (world_size, 1))


def _world_size() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def device_mesh(shape: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the started process group, whose
    world size must be the mesh's size (rank r at row-major position r)."""
    from torch.distributed.device_mesh import init_device_mesh
    if _world_size() != math.prod(shape.sizes):
        raise ValueError(f"a {shape.sizes} mesh needs "
                         f"{math.prod(shape.sizes)} ranks, the group has "
                         f"{_world_size()}")
    return init_device_mesh(device_type, shape.sizes,
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh over 256 (512 across pods) ranks."""
    return device_mesh(production_mesh_shape(multi_pod=multi_pod),
                       device_type)


def make_local_mesh(device_type: str = "cuda"):
    """(world_size, 1) ``("data", "model")`` over the started process group,
    on the card unless ``device_type="cpu"``."""
    return device_mesh(local_mesh_shape(_world_size()), device_type)
