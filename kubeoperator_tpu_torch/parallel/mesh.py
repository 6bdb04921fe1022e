"""Device meshes over the process group.

Counterpart of `MeshSpec`, `format_axes`, `build_mesh`, `mesh_for_topology`
and `flat_axis_mesh` in `kubeoperator_tpu/parallel/mesh.py`. One process drives one card, so a
mesh is a `torch.distributed.device_mesh.DeviceMesh` over ranks of the
default group (set up by `parallel/multislice.py::initialize_from_env`):
all of them, or a list of them, as the reference builds meshes over a
prefix of its devices. Building a mesh creates its process groups, which
every rank of the default group takes part in; a rank outside the mesh
then sits out whatever runs on it (`in_mesh`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from kubeoperator_tpu_torch.parallel.topology import SliceTopology
from kubeoperator_tpu_torch.utils.errors import TopologyError


@dataclass(frozen=True)
class MeshSpec:
    """Declarative named-axis mesh description: ordered ``(name, length)``
    pairs, decoupled from how ranks get arranged (`build_mesh` below). The
    validation net's factored (dp, pp, sp, tp) mesh and the train smoke
    route through here.

    Parse form (the `--mesh` CLI flag): ``"data=4,fsdp=2"`` — ordered,
    ``name=length`` pairs, omitted axes absent (not size-1: axis names in
    the spec are a promise to the step function). One axis may be ``-1``
    when `parse` is given `n_devices`: it absorbs whatever the named axes
    leave over, the same convention as numpy reshape."""

    axes: tuple[tuple[str, int], ...]

    def __post_init__(self) -> None:
        names = [n for n, _ in self.axes]
        if not names:
            raise TopologyError("mesh spec needs at least one axis")
        if len(set(names)) != len(names):
            raise TopologyError(f"duplicate mesh axis names in {names}")
        for name, length in self.axes:
            if not isinstance(length, int) or length <= 0:
                raise TopologyError(
                    f"mesh axis {name!r} needs a positive integer length, "
                    f"got {length!r}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def axis_lengths(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def total_devices(self) -> int:
        return math.prod(self.axis_lengths)

    @classmethod
    def parse(cls, text: str, axis_names: Sequence[str] | None = None,
              n_devices: int | None = None) -> "MeshSpec":
        """``"data=4,fsdp=2"`` → MeshSpec. `axis_names`, when given, is the
        closed set of axes the workload understands — a typo'd axis is an
        error naming the allowed set, not a silently dead dimension."""
        pairs: list[tuple[str, int]] = []
        fill_at = None
        for part in [p.strip() for p in text.split(",") if p.strip()]:
            name, eq, raw = part.partition("=")
            name = name.strip()
            try:
                length = int(raw.strip()) if eq else 0
            except ValueError:
                length = 0
            if not eq or (length <= 0 and length != -1):
                raise TopologyError(
                    f"mesh spec part {part!r} must look like 'data=4' "
                    f"(or 'data=-1' to absorb the remaining devices)")
            if axis_names is not None and name not in axis_names:
                raise TopologyError(
                    f"unknown mesh axis {name!r} (allowed: "
                    f"{', '.join(axis_names)})")
            if any(n == name for n, _ in pairs):
                raise TopologyError(f"mesh axis {name!r} given twice")
            if length == -1:
                if fill_at is not None:
                    raise TopologyError("only one mesh axis may be -1")
                fill_at = len(pairs)
                length = 0   # patched below
            pairs.append((name, length))
        if not pairs:
            raise TopologyError("empty mesh spec (want e.g. 'data=4,tp=2')")
        if fill_at is not None:
            if n_devices is None:
                raise TopologyError(
                    f"mesh axis {pairs[fill_at][0]!r}=-1 needs a known "
                    f"device count to fill against")
            rest = math.prod(s for _, s in pairs if s)
            if rest == 0 or n_devices % rest:
                raise TopologyError(
                    f"cannot fill {pairs[fill_at][0]!r}: {n_devices} "
                    f"devices not divisible by the named axes ({rest})")
            pairs[fill_at] = (pairs[fill_at][0], n_devices // rest)
        return cls(axes=tuple(pairs))

    def build(self, device_type: str | None = None,
              ranks: Sequence[int] | None = None) -> DeviceMesh:
        """Materialize over `ranks` (default: every rank of the default
        group), whose number must be `total_devices`. Every rank of the
        default group calls this, in or out of `ranks`."""
        return build_mesh(self.axis_names, self.axis_lengths, device_type,
                          ranks)

    def describe(self) -> dict:
        """The JSON face ({axis: length}, insertion-ordered)."""
        return {n: s for n, s in self.axes}

    def __str__(self) -> str:
        return format_axes(self.describe())


def format_axes(axes: dict) -> str:
    """{axis: length} → the canonical ``"data=4,fsdp=2"`` string — the
    inverse of MeshSpec.parse."""
    return ",".join(f"{n}={s}" for n, s in axes.items())


def build_mesh(
    axis_names: Sequence[str] = ("data", "model"),
    axis_shape: Sequence[int] | None = None,
    device_type: str | None = None,
    ranks: Sequence[int] | None = None,
) -> DeviceMesh:
    """A mesh over `ranks` of the default group (default: all of them), laid
    out row-major in their order.

    If `axis_shape` is omitted, all ranks land on the first axis and the
    rest get size 1. `device_type` defaults to the group's: "cuda" under
    NCCL, "cpu" under gloo. Every rank of the default group calls this,
    since creating the mesh's groups is collective over it."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.multislice.initialize_from_env "
            "first")
    world = dist.get_world_size()
    n = world if ranks is None else len(ranks)
    if axis_shape is None:
        axis_shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(axis_shape) != n:
        raise TopologyError(
            f"axis_shape {tuple(axis_shape)} needs {math.prod(axis_shape)} "
            f"devices, have {n}")
    if ranks is not None and (len(set(ranks)) != n
                              or not all(0 <= r < world for r in ranks)):
        raise TopologyError(
            f"mesh ranks {list(ranks)} must be distinct ranks of the "
            f"{world}-rank process group")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if ranks is None:
        return init_device_mesh(device_type, tuple(axis_shape),
                                mesh_dim_names=tuple(axis_names))
    layout = torch.tensor(list(ranks), dtype=torch.int).view(tuple(axis_shape))
    return DeviceMesh(device_type, layout, mesh_dim_names=tuple(axis_names))


def topology_axes(topo: SliceTopology, axis_names: Sequence[str] | None = None
                  ) -> tuple[list[str], list[int]]:
    """(axis names, axis lengths) of the mesh that mirrors the slice's
    physical ICI mesh: ``ici_i`` per ICI axis, and for a multislice a
    leading ``dcn`` axis with one entry per slice, so cross-slice traffic
    is explicitly on the slow axis."""
    shape: list[int] = list(topo.ici_mesh)
    if axis_names is None:
        axis_names = [f"ici_{i}" for i in range(len(shape))]
        if topo.is_multislice:
            axis_names = ["dcn"] + list(axis_names)
    axis_names = list(axis_names)
    if topo.is_multislice:
        shape = [topo.num_slices] + shape
    if len(axis_names) != len(shape):
        raise TopologyError(
            f"{len(shape)} mesh axes but {len(axis_names)} names given")
    return axis_names, shape


def mesh_for_topology(topo: SliceTopology,
                      axis_names: Sequence[str] | None = None,
                      device_type: str | None = None) -> DeviceMesh:
    """`topology_axes`'s mesh over every rank of the default group, whose
    size must be the topology's device count."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.multislice.initialize_from_env "
            "first")
    found = dist.get_world_size()
    if found != topo.device_count:
        raise TopologyError(
            f"topology {topo.accelerator_type} x{topo.num_slices} expects "
            f"{topo.device_count} devices, found {found}")
    names, shape = topology_axes(topo, axis_names)
    return build_mesh(names, shape, device_type)


def flat_axis_mesh(name: str = "devices",
                   device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over every rank — the all-reduce smoke-test mesh."""
    return build_mesh((name,), None, device_type)


def mesh_sizes(mesh: DeviceMesh | MeshSpec) -> dict[str, int]:
    """{axis: length} of a built mesh or a spec, in axis order."""
    if isinstance(mesh, MeshSpec):
        return mesh.describe()
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


def mesh_ranks(mesh: DeviceMesh) -> list[int]:
    """The mesh's ranks of the default group, row-major."""
    return mesh.mesh.flatten().tolist()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
