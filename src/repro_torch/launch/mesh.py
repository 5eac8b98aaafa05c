"""The production mesh of the LM: a ``DeviceMesh`` over the process group.

The port of the JAX package's ``launch/mesh.py``: the same shapes and axis
names — 16 × 16 ``data`` × ``model`` a pod, and a leading 2-way ``pod``
axis for two pods — over the ranks of the ``torch.distributed`` world, one
rank a device. A world of another size raises. The card's roofline
constants live in ``launch/roofline.py``; the JAX file's TPU constants
have no place here.
"""
from __future__ import annotations

import math


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """A ``DeviceMesh`` of the production shape over the current world
    (``runtime.platform.process_group``), on ``device``'s type (``None``
    is the card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.utils.device import resolve_device

    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} {axes} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


__all__ = ["make_production_mesh", "production_mesh_shape"]
