"""Mesh builders (port of ``repro/launch/mesh.py``), over the process
group's ranks: one rank a device, as a JAX process has its devices.

Functions, never module-level meshes: importing this module touches no
process group.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist import sharding as shd

#: the production meshes (``make_production_mesh``): one 16 x 16 pod of
#: 256 ranks, or two pods of 512
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> shd.Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks); the
    process group must hold exactly that many."""
    shape, axes = PRODUCTION[multi_pod]
    return shd.make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> shd.Mesh:
    """Small ``("data", "model")`` mesh over the process group (one
    rank when there is none), each size clamped as the JAX builder
    clamps to the device count."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n)
    model = min(model, n // data)
    return shd.make_mesh((data, model), ("data", "model"), device=device)
