"""Ring attention as a health check (port of `ops/longcontext_check.py`).

  verify_ring_attention  the sharded result must match full attention on
                         the gathered arrays within 2e-4; any permute
                         ordering bug, stale block or mask off-by-one
                         fails it. The verdict is agreed over the group.
  bench_ring_attention   sustained ring-attention TFLOP/s, differential
                         timed like every other workload.

The inputs come from numpy's `default_rng(0)`, as in the reference, so the
same arrays reach both packages.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.ops.timing import differential_time_per_iter
from kubeoperator_tpu_torch.parallel.longcontext import (
    reference_attention,
    ring_attention,
    ring_attention_local,
)
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh, mesh_device

AXIS = "sp"


@contextlib.contextmanager
def full_f32_matmul():
    """float32 products in full float32 on the card (no TF32), as the
    reference's `precision=HIGHEST`; restores the setting after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _shard(a: np.ndarray, rank: int, s_local: int, dev, dtype=torch.float32):
    """This rank's sequence slice of a global [b, s, h, d] array."""
    part = np.ascontiguousarray(a[:, rank * s_local:(rank + 1) * s_local])
    return torch.from_numpy(part).to(device=dev, dtype=dtype)


def verify_ring_attention(mesh: DeviceMesh | None = None, causal: bool = True,
                          tol: float = 2e-4) -> bool:
    """Exactness gate: ring attention over the mesh against reference
    attention on the full arrays. Small f32 shapes: a correctness probe,
    not a throughput number."""
    mesh = mesh or flat_axis_mesh(AXIS)
    group = mesh.get_group(0)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = mesh_device(mesh)
    b, s_local, h, dh = 2, 8, 4, 16
    rng = np.random.default_rng(0)
    shape = (b, s_local * n, h, dh)
    q_h, k_h, v_h = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(3))
    with full_f32_matmul():
        q, k, v = (_shard(a, rank, s_local, dev) for a in (q_h, k_h, v_h))
        out = ring_attention(q, k, v, mesh, axis_name=mesh.mesh_dim_names[0],
                             causal=causal)
        full = [torch.from_numpy(a).to(dev) for a in (q_h, k_h, v_h)]
        want = reference_attention(*full, causal=causal)
        want = want[:, rank * s_local:(rank + 1) * s_local]
        ok = bool(torch.allclose(out, want, rtol=tol, atol=tol))
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


@dataclass(frozen=True)
class RingAttentionResult:
    n_devices: int
    seq_global: int
    heads: int
    head_dim: int
    causal: bool
    time_per_iter_s: float
    tflops: float

    def to_dict(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "seq_global": self.seq_global,
            "heads": self.heads,
            "head_dim": self.head_dim,
            "causal": self.causal,
            "time_per_iter_s": round(self.time_per_iter_s, 6),
            "tflops": round(self.tflops, 3),
        }


def bench_ring_attention(
    seq_per_device: int = 512,
    heads: int = 8,
    head_dim: int = 64,
    batch: int = 1,
    causal: bool = True,
    mesh: DeviceMesh | None = None,
    iters: int = 8,
    trials: int = 3,
    dtype: torch.dtype = torch.bfloat16,
) -> RingAttentionResult:
    """Sustained ring-attention throughput. The FLOP count is the standard
    4·b·h·dh·s² (QKᵀ + PV, both 2·…); the causal variant computes the full
    score block and masks, so the count is not halved."""
    mesh = mesh or flat_axis_mesh(AXIS)
    group = mesh.get_group(0)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = mesh_device(mesh)
    s_global = seq_per_device * n
    rng = np.random.default_rng(0)
    shape = (batch, s_global, heads, head_dim)
    q, k, v = (_shard(rng.standard_normal(shape).astype(np.float32), rank,
                      seq_per_device, dev, dtype) for _ in range(3))

    def run(m: int) -> float:
        u = q
        for _ in range(m):
            u = ring_attention_local(u, k, v, group, n, causal)
        # scalar readback: waits for every step before it
        return float(u.float().sum().item())

    dt = differential_time_per_iter(
        run, lo=max(iters // 4, 1), hi=max(iters, iters // 4 + 2),
        trials=max(trials, 1),
    )
    flops = 4.0 * batch * heads * head_dim * float(s_global) ** 2
    return RingAttentionResult(
        n_devices=n, seq_global=s_global, heads=heads, head_dim=head_dim,
        causal=causal, time_per_iter_s=dt, tflops=flops / dt / 1e12,
    )
