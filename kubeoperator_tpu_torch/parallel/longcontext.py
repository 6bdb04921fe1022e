"""Exact attention over a sequence sharded across ranks: ring and Ulysses.

Counterpart of `reference_attention`, `ring_attention_local`,
`ring_attention`, `seq_to_heads`, `heads_to_seq`, `ulysses_attention_local`
and `ulysses_attention` in `kubeoperator_tpu/parallel/longcontext.py`, in
the same [batch, seq, heads, dim] layout. Each rank holds a sequence shard; K/V
blocks rotate to the right neighbour (`parallel/comm.py::ppermute`) while an
online-softmax carry (o, m, l) in float32 keeps the result exact. The
reference rotates n times; the last rotation feeds nothing, so the port
makes n - 1. Like the reference it is differentiable: the rotation's
backward sends the gradient to the left neighbour, so the validation net
trains through it.

Precision follows the reference's `preferred_element_type=f32,
precision=HIGHEST`: operands keep their type and products accumulate into
a float32 result. On the card a bf16 product goes to `aten::bmm.dtype`
(bf16 operands, f32 output), which has no derivative formula, so
`_BmmF32` gives it one. Its gradient products take the float32
cotangent unrounded, as the reference's transpose does (an f32 x bf16
product with an f32 result): float32 products with the bf16 operand
widened. On the host, where that overload has no kernel, bf16 operands
are widened to f32 first, which is exact (a product of two bf16 values
fits in f32), so both give the reference's numbers up to summation order.
A float32 product, and so that gradient, needs
`torch.backends.cuda.matmul.allow_tf32 = False` on the card (PyTorch's
default), which `ops/longcontext_check.py` also sets for its exactness
check.

Ulysses trades the sequence shard for a head shard with one all-to-all
(`parallel/comm.py::all_to_all`, which has its transpose as backward), runs
full attention over the whole sequence for its heads, and trades back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.parallel.comm import all_to_all, ppermute

_NEG = -1e30  # finite -inf stand-in: masked logits underflow exp() to 0.0


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain full softmax attention, the single-device ground truth the ring
    is held against. [batch, seq, heads, dim] layout, computed in the
    inputs' type."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _bmm_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, K] @ [..., K, N] through `aten::bmm.dtype`: operands of one
    type, float32 accumulation and result (the card only)."""
    lead = a.shape[:-2]
    out = torch.ops.aten.bmm.dtype(a.reshape(-1, *a.shape[-2:]),
                                   b.reshape(-1, *b.shape[-2:]), torch.float32)
    return out.view(*lead, *out.shape[1:])


class _BmmF32(torch.autograd.Function):
    """`_bmm_dtype` with its gradient: grad_a = g @ bᵀ and grad_b = aᵀ @ g
    in float32 from the unrounded float32 cotangent g, the other operand
    widened (exact), each cast to its operand's type at the end."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_dtype(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        grad_a = torch.matmul(g, b.transpose(-1, -2).float())
        grad_b = torch.matmul(a.transpose(-1, -2).float(), g)
        return grad_a.to(a.dtype), grad_b.to(b.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, H, M, K] @ [B, H, K, N] -> float32 [B, H, M, N], operands in
    their own type, float32 accumulation and result; differentiable."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, n: int, causal: bool = False) -> torch.Tensor:
    """This rank's body of ring attention over `group` (n ranks).

    q/k/v: this rank's sequence shard, [batch, seq_local, heads, dim]. K/V
    hop to the next rank each step while q stays; after t hops the block
    came from rank (rank - t) mod n. Returns this rank's output shard in
    q's type."""
    rank = dist.get_rank(group)
    seq_local = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    b, _, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, seq_local, 1), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, seq_local, 1), dtype=torch.float32, device=q.device)
    local_pos = torch.arange(seq_local, device=q.device)
    qpos = rank * seq_local + local_pos
    qh = q.transpose(1, 2)                       # [b, h, q, d]
    kb, vb = k.contiguous(), v.contiguous()
    for t in range(n):
        s = _bmm_f32(qh, kb.permute(0, 2, 3, 1)) * scale   # [b, h, q, k]
        if causal:
            kpos = ((rank - t) % n) * seq_local + local_pos
            s = torch.where(kpos[None, None, None, :]
                            <= qpos[None, None, :, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)                 # masked entries -> 0
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        pv = _bmm_f32(p.to(vb.dtype), vb.transpose(1, 2))    # [b, h, q, d]
        o = o * correction.transpose(1, 2) + pv.transpose(1, 2)
        m = m_new
        if t < n - 1:
            kb, vb = ppermute(kb, group), ppermute(vb, group)
    return (o / l.transpose(1, 2)).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: DeviceMesh, axis_name: str = "sp",
                   causal: bool = False) -> torch.Tensor:
    """Sharded entry point: each process passes its sequence shard of q/k/v
    over the mesh axis `axis_name` (as a shard_map body sees it) and gets
    its shard of the exact attention output."""
    group = mesh.get_group(axis_name)
    return ring_attention_local(q, k, v, group, dist.get_world_size(group),
                                causal=causal)


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """Ulysses reshard over `group` (n ranks): [b, seq/n, H, d] -> [b, seq,
    H/n, d]. Head block j goes to rank j; the received sequence blocks are
    joined in rank order. Heads must divide by n."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(parts, group)                 # [src rank, b, s, H/n, d]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Inverse Ulysses reshard: [b, seq, H/n, d] -> [b, seq/n, H, d]."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    parts = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(parts, group)                 # [src rank, b, s/n, H/n, d]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            group, causal: bool = False) -> torch.Tensor:
    """This rank's body of Ulysses attention over `group`: reshard to heads,
    full attention over the whole sequence for this rank's heads, reshard
    back. Exact: one all-to-all for each input and one for the output."""
    qh, kh, vh = (seq_to_heads(t, group) for t in (q, k, v))
    return heads_to_seq(reference_attention(qh, kh, vh, causal=causal), group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: DeviceMesh, axis_name: str = "sp",
                      causal: bool = False) -> torch.Tensor:
    """Sharded Ulysses entry point (the contract of `ring_attention`)."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(
            f"{q.shape[2]} heads not divisible by axis {axis_name!r} "
            f"size {n}")
    return ulysses_attention_local(q, k, v, group, causal=causal)
