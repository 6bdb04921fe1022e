"""Plain reference of the Kimi-K2 block (`workloads/mla_moe.py`): the same
equations in float32 `torch` with TF32 off, written from DeepSeek-V3's
public modeling code, with no cache, no batching and no fused kernel.

It imports nothing of the port, so the tests hold the port against an
independent version. A configuration is any object with
`MlaMoeConfig`'s fields. Attention is computed a block of heads at a
time, so 64 heads of 8192² f32 scores need not be held at once. The
expert layer loops over the held experts and takes the tokens that
selected each. YaRN's frequencies are found with DeepSeek-V3's own
`yarn_find_correction_range` and `yarn_linear_ramp_mask`; pairs (2i, 2i+1)
are rotated in place (DeepSeek-V3 regroups them into halves first, the
same permutation of q and k, which leaves every score unchanged).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base, max_position):
    return (dim * math.log(max_position / (num_rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_position):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position))
    return max(low, 0), min(high, dim - 1)


def yarn_linear_ramp_mask(low, high, dim):
    if low == high:
        high += 0.001
    return ((torch.arange(dim, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)


def inv_frequencies(cfg) -> torch.Tensor:
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inter = 1.0 / (cfg.rope_factor
                   * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    low, high = yarn_find_correction_range(cfg.beta_fast, cfg.beta_slow, dim,
                                           base, cfg.rope_original_max_position)
    keep = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
    return inter * (1 - keep) + extra * keep


def softmax_scale(cfg) -> float:
    m = yarn_get_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rope(x: torch.Tensor, cfg) -> torch.Tensor:
    """x [rows, s, ..., d] with pair (2i, 2i+1) of position t rotated by
    t · f_i, times YaRN's cos/sin scale."""
    seq, d = x.shape[1], x.shape[-1]
    angle = torch.outer(torch.arange(seq, dtype=torch.float32),
                        inv_frequencies(cfg)).to(x.device)
    m = yarn_get_mscale(cfg.rope_factor, cfg.mscale) \
        / yarn_get_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    shape = (1, seq) + (1,) * (x.dim() - 3) + (d // 2,)
    cos, sin = (torch.cos(angle) * m).view(shape), (torch.sin(angle) * m).view(shape)
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack((even * cos - odd * sin, even * sin + odd * cos),
                       dim=-1).flatten(-2)


def attention(q, k, v, scale: float, mm, heads_per_block: int = 8):
    """Causal softmax attention of q, k [rows, s, h, dqk] and v [rows, s, h,
    dv]: [rows, s, h·dv], `heads_per_block` heads at a time."""
    rows, seq, h, _ = q.shape
    keep = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    out = []
    for h0 in range(0, h, heads_per_block):
        sl = slice(h0, h0 + heads_per_block)
        qh, kh, vh = (t[:, :, sl].transpose(1, 2) for t in (q, k, v))
        scores = mm(qh, kh.transpose(-1, -2)) * scale
        scores = scores.masked_fill(~keep, float("-inf"))
        out.append(mm(torch.softmax(scores, dim=-1), vh).transpose(1, 2))
    o = torch.cat(out, dim=2)
    return o.reshape(rows, seq, -1)


def mla(x, p, pre, cfg, mm):
    rows, seq, _ = x.shape
    h, nope, dr = cfg.heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    eps = cfg.rms_norm_eps
    q = mm(rms_norm(mm(x, p[pre + "wq_a"]), p[pre + "q_norm"], eps),
           p[pre + "wq_b"]).view(rows, seq, h, nope + dr)
    ckv = mm(x, p[pre + "wkv_a"])
    c, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    kv = mm(rms_norm(c, p[pre + "kv_norm"], eps), p[pre + "wkv_b"]).view(
        rows, seq, h, nope + cfg.v_head_dim)
    q = torch.cat((q[..., :nope], rope(q[..., nope:], cfg)), dim=-1)
    k_pe = rope(k_pe, cfg)[:, :, None].expand(rows, seq, h, dr)
    k = torch.cat((kv[..., :nope], k_pe), dim=-1)
    o = attention(q, k, kv[..., nope:], softmax_scale(cfg), mm)
    return mm(o, p[pre + "wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def routing(x, router, b_corr, cfg, mm):
    """(idx, w) for tokens x [T, hidden]: DeepSeek-V3's noaux_tc gate with
    one group."""
    scores = torch.sigmoid(mm(x.float(), router.float().t()))
    choice = scores + b_corr.float()
    idx = torch.topk(choice, cfg.experts_per_token, dim=-1, sorted=False)[1]
    w = scores.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def routed(x, p, pre, cfg, mm):
    """The held experts' part: for each held expert, the tokens that
    selected it, their weight times its SwiGLU."""
    idx, w = routing(x, p[pre + "router"], p[pre + "b_corr"], cfg, mm)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for slot, expert in enumerate(cfg.experts_held):
        hit = idx == expert                       # [T, k]
        tokens = hit.any(dim=-1).nonzero().flatten()
        weight = (w * hit).sum(dim=-1)[tokens]
        out = swiglu(x[tokens], p[pre + "experts_gate"][slot],
                     p[pre + "experts_up"][slot], p[pre + "experts_down"][slot],
                     mm)
        y = y.index_add(0, tokens, out * weight[:, None])
    return y


def ffn(x, p, i, cfg, mm):
    pre = f"l{i}."
    if i < cfg.n_dense_layers:
        return swiglu(x, p[pre + "w_gate"], p[pre + "w_up"], p[pre + "w_down"],
                      mm)
    flat = x.reshape(-1, x.shape[-1])
    y = routed(flat, p, pre, cfg, mm) + swiglu(
        flat, p[pre + "shared_gate"], p[pre + "shared_up"],
        p[pre + "shared_down"], mm)
    return y.view(x.shape)


def layer(x, p, i, cfg, mm):
    pre = f"l{i}."
    eps = cfg.rms_norm_eps
    h = x + mla(rms_norm(x, p[pre + "attn_norm"], eps), p, pre, cfg, mm)
    return h + ffn(rms_norm(h, p[pre + "ffn_norm"], eps), p, i, cfg, mm)


def logits(p, ids, cfg, mm):
    """Logits [rows, s, vocab_held] of token ids [rows, s]."""
    x = p["embed"].float()[ids]
    for i in range(cfg.n_dense_layers + cfg.n_moe_layers):
        x = layer(x, p, i, cfg, mm)
    return mm(rms_norm(x, p["final_norm"], cfg.rms_norm_eps), p["head"])


def loss_sum(p, batch, cfg, mm):
    """The sum over rows of the cross-entropy of each next id, for ids
    [rows, s + 1]."""
    y = logits(p, batch[:, :-1], cfg, mm)
    return F.cross_entropy(y.reshape(-1, y.shape[-1]).float(),
                           batch[:, 1:].reshape(-1), reduction="sum")


def mm_f32(a, b):
    return torch.matmul(a.float(), b.float())


def adamw_steps(p0: dict, batch, cfg, steps: int, frozen=(), b1=0.9,
                b2=0.999, eps=1e-8, weight_decay=1e-4, mm=mm_f32) -> dict:
    """`steps` AdamW steps of the mean cross-entropy over `batch` from `p0`
    in f32 (decay on every leaf with a dimension; `frozen` leaves kept),
    each update rounded to the leaf's own type. Returns each step's loss,
    the first gradient and the parameters after the last step."""
    no_tf32()
    keep = {k: v.dtype for k, v in p0.items()}
    p = {k: v.float() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    trained = [k for k in p if k not in frozen]
    denom = float(batch.shape[0] * (batch.shape[1] - 1))
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        leaves = {k: (v.requires_grad_() if k in trained else v)
                  for k, v in ((k, v.detach()) for k, v in p.items())}
        loss = loss_sum(leaves, batch, cfg, mm) / denom
        grads = dict(zip(trained, torch.autograd.grad(
            loss, [leaves[k] for k in trained])))
        losses.append(float(loss.detach()))
        if t == 1:
            grad1 = grads
        with torch.no_grad():
            for k in trained:
                g = grads[k]
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                u = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t))
                                               + eps)
                if p[k].dim() > 0:
                    u = u + weight_decay * p[k]
                p[k] = (p[k] - cfg.lr * u).to(keep[k]).float()
    return {"losses": losses, "grad1": grad1, "params": p}
