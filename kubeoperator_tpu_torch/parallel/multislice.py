"""The host env contract and the process-group bootstrap that reads it.

Counterpart of `kubeoperator_tpu/parallel/multislice.py`. `HostEnv`,
`host_envs`, `survivor_host_envs` and `degraded_mesh_spec` are copies of
the reference's: the env blocks one process per host is launched with
(the JobSet's), those of the surviving slices after a preemption, and the
(data, fsdp, tp) mesh the survivors re-shard onto. MEGASCALE_* is the
reference's DCN wiring for libtpu; the port hands it out unchanged and
reads none of it. `initialize_from_env` reads the same variables as the
reference's:

    KO_TPU_COORDINATOR_ADDRESS   host:port of rank 0's rendezvous store
    KO_TPU_NUM_PROCESSES         world size (one process per GPU)
    KO_TPU_PROCESS_ID            this process's rank

With no coordinator (or a world of one) it sets up a 1-rank group on an
in-process store, so the gate's collectives run through the same code at
n=1. NCCL on CUDA, gloo on the host. Idempotent: a second call returns
the device of the group already set up.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.topology import SliceTopology
from kubeoperator_tpu_torch.utils.device import resolve_device
from kubeoperator_tpu_torch.utils.errors import TopologyError


@dataclass(frozen=True)
class HostEnv:
    """Env contract for one worker process (one per host)."""

    coordinator_address: str      # "<host0>:<port>"
    num_processes: int            # total processes across all slices
    process_id: int               # global rank
    slice_id: int = 0             # which slice (multislice)
    num_slices: int = 1
    megascale_coordinator: str | None = None  # multislice DCN coordinator

    def to_env(self) -> dict[str, str]:
        env = {
            "KO_TPU_COORDINATOR_ADDRESS": self.coordinator_address,
            "KO_TPU_NUM_PROCESSES": str(self.num_processes),
            "KO_TPU_PROCESS_ID": str(self.process_id),
            "KO_TPU_SLICE_ID": str(self.slice_id),
        }
        if self.megascale_coordinator:
            env["MEGASCALE_COORDINATOR_ADDRESS"] = self.megascale_coordinator
            env["MEGASCALE_NUM_SLICES"] = str(self.num_slices)
            env["MEGASCALE_SLICE_ID"] = str(self.slice_id)
        return env


def _check_env_contract(topo: SliceTopology, coordinator_host: str,
                        port: int, multislice: bool) -> None:
    """Refuse malformed env-contract inputs: an empty env list or a bad
    coordinator would leave the workers hanging at rendezvous with
    nothing pointing at the cause."""
    if not str(coordinator_host or "").strip():
        raise TopologyError("host_envs needs a non-empty coordinator_host")
    if not 1 <= int(port) <= 65535:
        raise TopologyError(f"coordinator port {port} outside 1..65535")
    if multislice and port + 1 > 65535:
        # the megascale (DCN) coordinator is the NEXT port by contract
        raise TopologyError(
            f"multislice needs port+1 for the megascale coordinator; "
            f"{port}+1 exceeds 65535")
    if topo.total_hosts == 0:
        raise TopologyError(
            f"{topo.accelerator_type}: topology resolves to 0 hosts "
            f"({topo.chips} chips is neither a single-host shape nor a "
            f"multiple of {topo.chips_per_host} chips/host)")


def host_envs(
    topo: SliceTopology, coordinator_host: str, port: int = 8476
) -> list[HostEnv]:
    """Env blocks for every host process across the (multi)slice, rank 0 first."""
    _check_env_contract(topo, coordinator_host, port, topo.is_multislice)
    total = topo.total_hosts
    return [
        HostEnv(
            coordinator_address=f"{coordinator_host}:{port}",
            num_processes=total,
            process_id=rank,
            slice_id=rank // topo.hosts_per_slice,
            num_slices=topo.num_slices,
            megascale_coordinator=(
                f"{coordinator_host}:{port + 1}" if topo.is_multislice else None),
        )
        for rank in range(total)
    ]


def survivor_host_envs(
    topo: SliceTopology, coordinator_host: str, port: int = 8476,
    lost_slices: tuple[int, ...] = (),
) -> list[HostEnv]:
    """Env blocks for the hosts of the surviving slices after a preemption.
    Ranks are contiguous over the survivors and slice ids are renumbered
    0..S-1 in order; MEGASCALE_* drops away when one slice survives."""
    lost = set(int(s) for s in lost_slices)
    for sid in lost:
        if not 0 <= sid < topo.num_slices:
            raise TopologyError(
                f"lost slice {sid} outside 0..{topo.num_slices - 1}")
    survivors = [s for s in range(topo.num_slices) if s not in lost]
    if not survivors:
        raise TopologyError("no surviving slices to re-emit envs for")
    multislice = len(survivors) > 1
    _check_env_contract(topo, coordinator_host, port, multislice)
    total = len(survivors) * topo.hosts_per_slice
    return [
        HostEnv(
            coordinator_address=f"{coordinator_host}:{port}",
            num_processes=total,
            process_id=ordinal * topo.hosts_per_slice + worker,
            slice_id=ordinal,
            num_slices=len(survivors),
            megascale_coordinator=(
                f"{coordinator_host}:{port + 1}" if multislice else None),
        )
        for ordinal in range(len(survivors))
        for worker in range(topo.hosts_per_slice)
    ]


def degraded_mesh_spec(spec: MeshSpec, num_slices: int, lost: int = 1
                       ) -> tuple[MeshSpec, str]:
    """The (data, fsdp, tp) MeshSpec that ``num_slices - lost`` surviving
    slices re-shard onto, and the axis that absorbed the shrink: data
    first, then fsdp, never tp (it factors the model, not the batch). An
    axis absorbs the shrink only when its length scaled by
    survivors/num_slices is a positive integer; TopologyError when none
    can."""
    if num_slices < 2:
        raise TopologyError(
            "degraded_mesh_spec needs a multislice layout (num_slices >= 2)")
    if not 1 <= lost < num_slices:
        raise TopologyError(
            f"lost slices must be 1..{num_slices - 1}, got {lost}")
    survivors = num_slices - lost
    for axis in ("data", "fsdp"):
        for name, length in spec.axes:
            if name != axis:
                continue
            scaled = length * survivors
            if scaled % num_slices == 0 and scaled // num_slices >= 1:
                new_axes = tuple(
                    (n, scaled // num_slices if n == axis else s)
                    for n, s in spec.axes)
                return MeshSpec(axes=new_axes), axis
    raise TopologyError(
        f"mesh {spec} cannot re-shard onto {survivors}/{num_slices} "
        f"slices: no (data, fsdp) axis divides by the slice loss and tp "
        f"is never shrunk (it factors the model, not the batch)")


def initialize_from_env(device: torch.device | str | None = None) -> torch.device:
    """Join (or create) the default process group; return this rank's device.

    A rank's CUDA card is `rank % torch.cuda.device_count()`, which holds
    when every host runs one process per visible card."""
    dev = resolve_device(device)
    addr = os.environ.get("KO_TPU_COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("KO_TPU_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("KO_TPU_PROCESS_ID", "0"))
    multi = bool(addr) and nproc > 1
    if dev.type == "cuda":
        if multi:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if multi:
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                world_size=nproc, rank=rank)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    return dev
