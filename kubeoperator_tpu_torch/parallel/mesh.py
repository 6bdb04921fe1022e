"""Device meshes over the process group.

Counterpart of `build_mesh`/`flat_axis_mesh` in
`kubeoperator_tpu/parallel/mesh.py`. One process drives one card, so a
mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default group (set up by `parallel/multislice.py::initialize_from_env`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from kubeoperator_tpu_torch.utils.errors import TopologyError


def build_mesh(
    axis_names: Sequence[str] = ("data", "model"),
    axis_shape: Sequence[int] | None = None,
    device_type: str | None = None,
) -> DeviceMesh:
    """A mesh over every rank of the default group.

    If `axis_shape` is omitted, all ranks land on the first axis and the
    rest get size 1. `device_type` defaults to the group's: "cuda" under
    NCCL, "cpu" under gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.multislice.initialize_from_env "
            "first")
    n = dist.get_world_size()
    if axis_shape is None:
        axis_shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(axis_shape) != n:
        raise TopologyError(
            f"axis_shape {tuple(axis_shape)} needs {math.prod(axis_shape)} "
            f"devices, have {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(axis_shape),
                            mesh_dim_names=tuple(axis_names))


def flat_axis_mesh(name: str = "devices",
                   device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over every rank — the all-reduce smoke-test mesh."""
    return build_mesh((name,), None, device_type)
