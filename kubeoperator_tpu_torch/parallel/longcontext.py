"""Ring attention: exact attention over a sequence sharded across ranks.

Counterpart of `reference_attention`, `ring_attention_local` and
`ring_attention` in `kubeoperator_tpu/parallel/longcontext.py`, in the same
[batch, seq, heads, dim] layout. Each rank holds a sequence shard; K/V
blocks rotate to the right neighbour (`batch_isend_irecv`, as the port's
ppermute) while an online-softmax carry (o, m, l) in float32 keeps the
result exact. The reference rotates n times; the last rotation feeds
nothing, so the port makes n - 1.

Precision follows the reference's `preferred_element_type=f32,
precision=HIGHEST`: operands keep their type and products accumulate into
a float32 result. On the card a bf16 product goes to `aten::bmm.dtype`
(bf16 operands, f32 output); on the host, where that overload has no
kernel, bf16 operands are widened to f32 first, which is exact (a product
of two bf16 values fits in f32), so both give the reference's numbers up to
summation order. A float32 product needs `torch.backends.cuda.matmul.
allow_tf32 = False` on the card, which `ops/longcontext_check.py` sets for
its exactness check.

Ulysses all-to-all attention (the reference's `seq_to_heads` ...
`ulysses_attention`) is not ported yet (ROADMAP.md A3).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, H, M, K] @ [B, H, K, N] -> float32 [B, H, M, N], operands in
    their own type, float32 accumulation and result."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        lead = a.shape[:2]
        out = torch.ops.aten.bmm.dtype(a.reshape(-1, *a.shape[2:]),
                                       b.reshape(-1, *b.shape[2:]),
                                       torch.float32)
        return out.view(*lead, *out.shape[1:])
    return torch.matmul(a.float(), b.float())


def _rotate(x: torch.Tensor, group) -> torch.Tensor:
    """Send x to the right neighbour, return the left neighbour's."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    got = torch.empty_like(x)
    for work in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (rank + 1) % n),
                   group=group),
        dist.P2POp(dist.irecv, got,
                   dist.get_global_rank(group, (rank - 1) % n), group=group),
    ]):
        work.wait()
    return got


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
            kb, vb = _rotate(kb, group), _rotate(vb, group)
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
