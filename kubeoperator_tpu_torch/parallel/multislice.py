"""Process-group bootstrap from the host env contract.

Counterpart of `kubeoperator_tpu/parallel/multislice.py::initialize_from_env`,
reading the same variables:

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

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.utils.device import resolve_device


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
