"""Collectives that a gradient crosses, as `torch.autograd.Function`s.

Counterparts of the `lax` collectives the validation net differentiates
through inside `shard_map` (`lax.ppermute`, `lax.all_to_all`, `lax.psum`).
Each backward is the transpose of its forward:

  ppermute       send to the right neighbour; backward sends the gradient
                 to the left
  all_to_all     dim 0 of a [n, ...] tensor, non-tiled (rank i's output j
                 is rank j's input i); its own transpose
  psum           all-reduce sum forward, identity backward: every rank
                 seeds the backward of the same replicated value, so each
                 partial's cotangent is that seed (the Megatron row-parallel
                 output, and the loss)
  replicate      identity forward, all-reduce sum backward: a replicated
                 input feeding per-rank shards gets the sum of their
                 cotangents (the Megatron column-parallel input)
  all_gather     concatenate every rank's block along a dim; backward
                 reduce-scatters (sums) the cotangent back into blocks: the
                 gather-on-use GSPMD inserts for a weight sharded over an
                 axis whose ranks see different data (fsdp); over an axis
                 whose ranks see the same data (tp) each cotangent is
                 already whole, and the backward keeps this rank's block

A forward or backward issues its collectives in program order, and every
rank of a group runs the same graph, so all ranks meet each collective in
the same order. A group of one rank makes each op the identity and issues
nothing.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """x to rank (rank + shift) mod n of `group`; returns what rank
    (rank - shift) mod n sent."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    x = x.contiguous()
    got = torch.empty_like(x)
    for work in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x,
                   dist.get_global_rank(group, (rank + shift) % n), group=group),
        dist.P2POp(dist.irecv, got,
                   dist.get_global_rank(group, (rank - shift) % n), group=group),
    ]):
        work.wait()
    return got


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _own_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_grad):
        ctx.dim, ctx.group, ctx.sum_grad = dim, group, sum_grad
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = _reduce_scatter_dim(g, ctx.dim, ctx.group)
        else:
            g = _own_block(g, ctx.dim, ctx.group)
        return g, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _single(group) -> bool:
    return dist.get_world_size(group) == 1


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    """`lax.ppermute` with perm [(i, (i + 1) % n)] over `group`."""
    return x if _single(group) else _PPermute.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """`lax.all_to_all(x, axis, 0, 0)` over `group`: x is [n, ...]."""
    return x if _single(group) else _AllToAll.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum over `group`; the backward passes the cotangent
    through unchanged."""
    return x if _single(group) else _Psum.apply(x, group)


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the cotangent over `group`."""
    return x if _single(group) else _Replicate.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group,
               sum_grad: bool = True) -> torch.Tensor:
    """All-gather along `dim` over `group`. The backward hands each rank its
    block of the cotangent: summed over the group (reduce-scatter) when its
    ranks see different data, as is (`sum_grad=False`) when they see the
    same data and each rank's cotangent is already the whole one."""
    return x if _single(group) else _AllGather.apply(x, dim, group, sum_grad)


def axes_group(mesh: DeviceMesh, axes: tuple[str, ...]):
    """The process group over the ranks that differ only along `axes`
    (the flattened sub-mesh). Every rank must call this, in the same
    order, since it creates one group per coordinate of the other axes."""
    names = list(mesh.mesh_dim_names)
    kept = [names.index(a) for a in axes]
    other = [i for i in range(len(names)) if i not in kept]
    size = math.prod(mesh.size(i) for i in kept)
    ranks = mesh.mesh.permute(*other, *kept).reshape(-1, size)
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return group
