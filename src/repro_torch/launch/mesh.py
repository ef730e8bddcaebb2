"""Production mesh builders (port of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 ranks ("data", "model"). Multi-pod: 2 x 16 x 16 =
512 ranks ("pod", "data", "model"), the pod axis extending data
parallelism. A mesh covers the whole default process group, so these need
``repro_torch.distributed.mesh.init`` with that many ranks first.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} {axes} needs "
                           f"{math.prod(shape)} ranks; the process group has "
                           f"{world or 'not been started'}")
    return make_mesh(shape, axes, device)


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    device: str | torch.device = "cuda") -> Mesh:
    """A ("data", "model") mesh over the ranks of the process group."""
    return make_mesh((n_data, n_model), ("data", "model"), device)
