"""Plain reference of Kimi-K2-Instruct's DeepSeek-V3 block as the tenant
workload runs it (`kubeoperator_tpu_torch/workloads/mla_moe.py`), on one
expert-parallel card's share: latent attention with YaRN rotary, a dense
SwiGLU layer, then MoE layers whose sigmoid router picks the top 8 of all
384 experts and of which this card computes its 8 held experts' part plus
the shared expert; the loss the mean cross-entropy of each next id over
the vocabulary slice; AdamW.

Written from DeepSeek-V3's public modeling code in plain `torch`, in the
precision of the product `mm` it is given (`kobench/reference/precision.py`:
float32 with TF32 off, or the fp8 control); everything else in float32.
No cache, no fused kernel: attention takes the full masked score matrix
of 8 heads at a time. To fit the card beside its own float32 state, the
batch goes `reference_rows` rows at a time and each layer, and within it
each block of heads, is recomputed in backward (`torch.utils.checkpoint`),
which changes no value.

The batch of the cell is the one the training entry feeds: numpy's
``default_rng(seed + 1)`` ids, uniform over the slice, [rows, s + 1].
This module draws it again itself.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kobench import inputs

HEADS_PER_BLOCK = 8


def dims(cfg: dict) -> SimpleNamespace:
    """The configuration file's keys under the model's own names (those of
    the port's `MlaMoeConfig`)."""
    rope = cfg["rope_scaling"]
    dep = cfg["deployment"]
    dense = cfg["first_k_dense_replace"]
    return SimpleNamespace(
        hidden=cfg["hidden_size"], heads=cfg["num_attention_heads"],
        q_lora_rank=cfg["q_lora_rank"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], intermediate=cfg["intermediate_size"],
        moe_intermediate=cfg["moe_intermediate_size"],
        n_routed_experts=dep["router_width"],
        experts_per_token=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        rope_theta=float(cfg["rope_theta"]), rope_factor=float(rope["factor"]),
        rope_original_max_position=rope["original_max_position_embeddings"],
        beta_fast=float(rope["beta_fast"]), beta_slow=float(rope["beta_slow"]),
        mscale=float(rope["mscale"]), mscale_all_dim=float(rope["mscale_all_dim"]),
        rms_norm_eps=cfg["rms_norm_eps"], n_dense_layers=dense,
        n_moe_layers=cfg["num_hidden_layers"] - dense,
        experts_held=tuple(dep["experts_held"]), vocab_held=cfg["vocab_size"],
        b_local=cfg["b_local"], s_local=cfg["s_local"], dtype=cfg["dtype"],
        init_scale=cfg["init_scale"], lr=cfg["optimizer"]["lr"])


def weight_shapes(cfg: dict) -> dict:
    """{leaf: shape} in draw order, named as the program names them."""
    m = dims(cfg)
    d, h = m.hidden, m.heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {"embed": (m.vocab_held, d)}
    for i in range(m.n_dense_layers + m.n_moe_layers):
        pre = f"l{i}."
        shapes.update({
            pre + "attn_norm": (d,), pre + "wq_a": (d, m.q_lora_rank),
            pre + "q_norm": (m.q_lora_rank,), pre + "wq_b": (m.q_lora_rank, h * qk),
            pre + "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            pre + "kv_norm": (m.kv_lora_rank,),
            pre + "wkv_b": (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
            pre + "wo": (h * m.v_head_dim, d), pre + "ffn_norm": (d,)})
        if i < m.n_dense_layers:
            f = m.intermediate
            shapes.update({pre + "w_gate": (d, f), pre + "w_up": (d, f),
                           pre + "w_down": (f, d)})
        else:
            f, e = m.moe_intermediate, len(m.experts_held)
            fs = f * m.n_shared_experts
            shapes.update({
                pre + "router": (m.n_routed_experts, d),
                pre + "b_corr": (m.n_routed_experts,),
                pre + "experts_gate": (e, d, f), pre + "experts_up": (e, d, f),
                pre + "experts_down": (e, f, d), pre + "shared_gate": (d, fs),
                pre + "shared_up": (d, fs), pre + "shared_down": (fs, d)})
    shapes["final_norm"] = (d,)
    shapes["head"] = (d, m.vocab_held)
    return shapes


def weights(cfg: dict, seed: int, device) -> dict:
    """The initial weights of `seed` on `device`, one generator in draw
    order: N(0, 1) × init_scale rounded to the state type; norms one;
    b_corr N(0, 1) × b_corr_scale in float32."""
    gen = inputs.generator(seed, device)
    dtype = inputs.DTYPES[cfg["dtype"]]
    out = {}
    for name, shape in weight_shapes(cfg).items():
        if name.endswith("norm"):
            out[name] = torch.ones(shape, dtype=dtype, device=gen.device)
        elif name.endswith("b_corr"):
            out[name] = inputs.normal(shape, gen, torch.float32,
                                      cfg["b_corr_scale"])
        else:
            out[name] = inputs.normal(shape, gen, dtype, cfg["init_scale"])
    return out


def frozen(name: str) -> bool:
    return name.endswith("b_corr")


def global_batch(cfg: dict) -> int:
    mesh = cfg["mesh"]
    return cfg["b_local"] * mesh["data"] * mesh["fsdp"]


def entry_batch(cfg: dict, seed: int, device) -> torch.Tensor:
    """The training entry's ids for `seed`, drawn again: [rows, s + 1]."""
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(0, cfg["vocab_size"],
                       size=(global_batch(cfg), cfg["s_local"] + 1))
    return torch.from_numpy(ids).to(device)


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_frequencies(m) -> torch.Tensor:
    """DeepSeek-V3's YaRN frequencies: yarn_find_correction_range's ramp
    between the extrapolated and the interpolated ones."""
    dim, base = m.qk_rope_head_dim, m.rope_theta

    def correction_dim(rotations):
        return dim * math.log(m.rope_original_max_position
                              / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(m.beta_fast)), 0)
    high = min(math.ceil(correction_dim(m.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    keep = 1.0 - ramp
    return extra / m.rope_factor * (1 - keep) + extra * keep


def softmax_scale(m) -> float:
    s = yarn_get_mscale(m.rope_factor, m.mscale_all_dim)
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5 * s * s


def rope(x: torch.Tensor, m) -> torch.Tensor:
    """Pair (2i, 2i+1) of position t of x [rows, s, ..., d] rotated by
    t · f_i (cos/sin scale mscale / mscale_all_dim)."""
    seq, d = x.shape[1], x.shape[-1]
    angle = torch.outer(torch.arange(seq, dtype=torch.float32),
                        inv_frequencies(m)).to(x.device)
    c = yarn_get_mscale(m.rope_factor, m.mscale) \
        / yarn_get_mscale(m.rope_factor, m.mscale_all_dim)
    shape = (1, seq) + (1,) * (x.dim() - 3) + (d // 2,)
    cos, sin = (torch.cos(angle) * c).view(shape), (torch.sin(angle) * c).view(shape)
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack((even * cos - odd * sin, even * sin + odd * cos),
                       dim=-1).flatten(-2)


def _heads_attention(q, k, v, scale, mm):
    seq = q.shape[2]
    keep = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    scores = (mm(q, k.transpose(-1, -2)) * scale).masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def attention(q, k, v, scale, mm):
    """Causal softmax attention of q, k [rows, s, h, 192] and v [rows, s,
    h, 128], `HEADS_PER_BLOCK` heads at a time: [rows, s, h·128]."""
    rows, seq, h, _ = q.shape
    out = []
    for h0 in range(0, h, HEADS_PER_BLOCK):
        sl = slice(h0, h0 + HEADS_PER_BLOCK)
        qh, kh, vh = (t[:, :, sl].transpose(1, 2) for t in (q, k, v))
        o = checkpoint(_heads_attention, qh, kh, vh, scale, mm,
                       use_reentrant=False)
        out.append(o.transpose(1, 2))
    return torch.cat(out, dim=2).reshape(rows, seq, -1)


def mla(x, p, pre, m, mm):
    rows, seq, _ = x.shape
    h, nope, dr = m.heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    eps = m.rms_norm_eps
    q = mm(rms_norm(mm(x, p[pre + "wq_a"]), p[pre + "q_norm"], eps),
           p[pre + "wq_b"]).view(rows, seq, h, nope + dr)
    ckv = mm(x, p[pre + "wkv_a"])
    c, k_pe = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    kv = mm(rms_norm(c, p[pre + "kv_norm"], eps), p[pre + "wkv_b"]).view(
        rows, seq, h, nope + m.v_head_dim)
    q = torch.cat((q[..., :nope], rope(q[..., nope:], m)), dim=-1)
    k_pe = rope(k_pe, m)[:, :, None].expand(rows, seq, h, dr)
    k = torch.cat((kv[..., :nope], k_pe), dim=-1)
    return mm(attention(q, k, kv[..., nope:], softmax_scale(m), mm), p[pre + "wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def routing(x, router, b_corr, m, mm):
    """DeepSeek-V3's noaux_tc gate with one group: the top k of the sigmoid
    scores plus b_corr; weights the scores of those, over their sum (+1e-20),
    times the routed scaling factor."""
    scores = torch.sigmoid(mm(x.float(), router.float().t()))
    idx = torch.topk(scores + b_corr.float(), m.experts_per_token, dim=-1,
                     sorted=False)[1]
    w = scores.gather(1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m.routed_scaling_factor


def moe(x, p, pre, m, mm):
    """The held experts' part for the tokens that chose each, plus the
    shared expert, for x [T, hidden]."""
    idx, w = routing(x, p[pre + "router"], p[pre + "b_corr"], m, mm)
    y = swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"],
               p[pre + "shared_down"], mm)
    for slot, expert in enumerate(m.experts_held):
        hit = idx == expert
        tokens = hit.any(dim=-1).nonzero().flatten()
        if not len(tokens):           # an expert no token chose adds nothing
            continue
        weight = (w * hit).sum(dim=-1)[tokens]
        out = swiglu(x[tokens], p[pre + "experts_gate"][slot],
                     p[pre + "experts_up"][slot], p[pre + "experts_down"][slot], mm)
        y = y.index_add(0, tokens, out * weight[:, None])
    return y


def layer(x, p, i, m, mm):
    pre = f"l{i}."
    eps = m.rms_norm_eps
    h = x + mla(rms_norm(x, p[pre + "attn_norm"], eps), p, pre, m, mm)
    f_in = rms_norm(h, p[pre + "ffn_norm"], eps)
    if i < m.n_dense_layers:
        f = swiglu(f_in, p[pre + "w_gate"], p[pre + "w_up"], p[pre + "w_down"], mm)
    else:
        f = moe(f_in.reshape(-1, f_in.shape[-1]), p, pre, m, mm).view(f_in.shape)
    return h + f


def loss_sum(p, ids, m, mm):
    """The summed cross-entropy of each next id over rows of ids [rows,
    s + 1], each layer recomputed in backward."""
    x = p["embed"].float()[ids[:, :-1]]
    for i in range(m.n_dense_layers + m.n_moe_layers):
        x = checkpoint(layer, x, p, i, m, mm, use_reentrant=False)
    y = mm(rms_norm(x, p["final_norm"], m.rms_norm_eps), p["head"])
    return F.cross_entropy(y.reshape(-1, y.shape[-1]).float(),
                           ids[:, 1:].reshape(-1), reduction="sum")


def train_steps(p0: dict, ids: torch.Tensor, cfg: dict, steps: int, mm) -> dict:
    """`steps` AdamW steps of the mean cross-entropy over ids from `p0`, in
    float32 (decay on every leaf; b_corr kept), each update rounded to the
    state type. Returns each step's loss, the first gradient (on the
    host) and the parameters after the last step."""
    m, opt = dims(cfg), cfg["optimizer"]
    state = inputs.DTYPES[cfg["dtype"]]
    p = {k: v.to(torch.float32, copy=True) for k, v in p0.items()}
    trained = [k for k in p if not frozen(k)]
    for k in trained:
        p[k].requires_grad_()
    mu = {k: torch.zeros_like(p[k]) for k in trained}
    nu = {k: torch.zeros_like(p[k]) for k in trained}
    rows, block = ids.shape[0], cfg["reference_rows"]
    denom = float(rows * (ids.shape[1] - 1))
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        total = 0.0
        for i in range(0, rows, block):
            loss = loss_sum(p, ids[i:i + block], m, mm) / denom
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if t == 1:
            grad1 = {k: p[k].grad.to("cpu", copy=True) for k in trained}
        with torch.no_grad():
            for k in trained:
                g = p[k].grad
                mu[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                nu[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                u = (mu[k] / (1 - opt["b1"] ** t)) / (
                    torch.sqrt(nu[k] / (1 - opt["b2"] ** t)) + opt["eps"])
                u.add_(opt["weight_decay"] * p[k])
                p[k].sub_(opt["lr"] * u)
                p[k].copy_(p[k].to(state))
                p[k].grad = None
    del mu, nu
    return {"losses": losses, "grad1": grad1,
            "params": {k: v.detach() for k, v in p.items()}}
