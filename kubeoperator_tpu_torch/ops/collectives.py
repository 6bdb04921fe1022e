"""Collective bus-bandwidth benchmarks over a device mesh.

Counterpart of `kubeoperator_tpu/ops/collectives.py`. Each process holds
one rank's shard; the collectives are `torch.distributed` calls on the
mesh's group (NCCL on CUDA, gloo on the host):

    psum            all_reduce, then / n
    all_gather      all_gather_into_tensor, then keep this rank's slice
    reduce_scatter  reduce_scatter_tensor / n, then tile back to full size
    all_to_all      all_to_all_single
    ppermute        batch_isend_irecv to the right neighbour

Bus-bandwidth formulas follow the nccl-tests conventions, as in the
reference:

    all_reduce      busbw = 2 * (n-1)/n * S / t
    all_gather      busbw =     (n-1)   * S / t
    reduce_scatter  busbw =     (n-1)/n * S / t
    all_to_all      busbw =     (n-1)/n * S / t
    ppermute (ring) busbw =               S / t

with S = the per-rank shard bytes. Iterations are chained (each one's
output is the next one's input) and end in a scalar readback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.ops.timing import differential_time_per_iter
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh, mesh_device

AXIS = "devices"


@dataclass(frozen=True)
class CollectiveResult:
    op: str
    n_devices: int
    bytes_per_device: int
    time_per_iter_s: float
    algbw_gbps: float   # S / t
    busbw_gbps: float   # hardware-bus normalized (formulas above)

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def _bus_factor(op: str, n: int) -> float:
    if n <= 1:
        return 1.0
    if op == "psum":
        return 2.0 * (n - 1) / n
    if op == "all_gather":
        return float(n - 1)  # each device receives (n-1) remote shards of S
    if op in ("reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0  # ppermute


def collective_step(op: str, mesh: DeviceMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """One chained iteration of `op` on this rank's 1-D shard. The step may
    reuse its input's storage (psum reduces in place)."""
    group = mesh.get_group(0)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    if op == "psum":
        def body(x):
            dist.all_reduce(x, group=group)
            return x.div_(n)  # keep magnitude stable across iterations
    elif op == "all_gather":
        def body(x):
            g = x.new_empty(n * x.numel())
            dist.all_gather_into_tensor(g, x, group=group)
            return g.narrow(0, rank * x.numel(), x.numel())
    elif op == "reduce_scatter":
        def body(x):
            s = x.new_empty(x.numel() // n)
            dist.reduce_scatter_tensor(s, x, group=group)
            return s.div_(n).repeat(n)  # local re-expand so iterations chain
    elif op == "all_to_all":
        def body(x):
            z = torch.empty_like(x)
            dist.all_to_all_single(z, x, group=group)
            return z
    elif op == "ppermute":
        right = dist.get_global_rank(group, (rank + 1) % n)
        left = dist.get_global_rank(group, (rank - 1) % n)

        def body(x):
            if n == 1:
                return x  # the one-device ring is the identity
            r = torch.empty_like(x)
            for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, right, group=group),
                dist.P2POp(dist.irecv, r, left, group=group),
            ]):
                work.wait()
            return r
    else:
        raise ValueError(f"unknown collective {op!r}")
    return body


def run_chain(op: str, x: torch.Tensor, iters: int,
              mesh: DeviceMesh) -> torch.Tensor:
    """`iters` chained iterations of `op` starting from a copy of `x`."""
    body = collective_step(op, mesh)
    v = x.clone()
    for _ in range(iters):
        v = body(v)
    return v


def bench_collective(
    op: str = "psum",
    size_mb: float = 16.0,
    mesh: DeviceMesh | None = None,
    iters: int = 10,
    trials: int = 3,
    dtype: torch.dtype = torch.float32,
) -> CollectiveResult:
    """Measure one collective's sustained bus bandwidth. `iters` is the high
    iteration count of the differential measurement; `trials` the number of
    timed rounds (median taken). Warmup is handled inside the timer."""
    mesh = mesh or flat_axis_mesh(AXIS)
    n = mesh.size()
    elem = torch.empty((), dtype=dtype).element_size()
    per_dev = max(int(size_mb * 1e6) // elem, 128)
    if op in ("all_to_all", "reduce_scatter"):
        per_dev = max(per_dev // n * n, n)  # shard must divide by n
    x = torch.ones(per_dev, dtype=dtype, device=mesh_device(mesh))

    def run(k: int) -> float:
        # scalar readback: waits for every collective before it
        return float(run_chain(op, x, k, mesh).sum().item())

    dt = differential_time_per_iter(
        run, lo=max(iters // 8, 1), hi=max(iters, iters // 8 + 2),
        trials=max(trials, 1),
    )
    bytes_per_dev = per_dev * elem
    algbw = bytes_per_dev / dt / 1e9
    busbw = algbw * _bus_factor(op, n)
    return CollectiveResult(
        op=op, n_devices=n, bytes_per_device=bytes_per_dev,
        time_per_iter_s=dt, algbw_gbps=algbw, busbw_gbps=busbw,
    )


def verify_psum_correctness(mesh: DeviceMesh | None = None) -> bool:
    """All-reduce of per-rank rank vectors must equal sum(0..n-1) on every
    rank; the verdict itself is min-reduced so all ranks agree on it."""
    mesh = mesh or flat_axis_mesh(AXIS)
    group = mesh.get_group(0)
    n = dist.get_world_size(group)
    dev = mesh_device(mesh)
    mine = torch.full((8,), float(dist.get_rank(group)),
                      dtype=torch.float32, device=dev)
    dist.all_reduce(mine, group=group)
    ok = torch.all(mine == n * (n - 1) / 2).to(torch.int32).reshape(1)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    return bool(ok.item())


def run_collective_suite(
    ops: tuple[str, ...] = ("psum", "all_gather", "reduce_scatter", "ppermute"),
    sizes_mb: tuple[float, ...] = (1.0, 8.0, 32.0),
    mesh: DeviceMesh | None = None,
    iters: int = 10,
) -> list[CollectiveResult]:
    """NCCL-tests-style sweep: every op at every size."""
    mesh = mesh or flat_axis_mesh(AXIS)
    results = []
    for op in ops:
        for size in sizes_mb:
            results.append(
                bench_collective(op, size_mb=size, mesh=mesh, iters=iters)
            )
    return results
