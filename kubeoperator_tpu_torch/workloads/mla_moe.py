"""The tenant workload's second model: the DeepSeek-V3 block of Kimi K2
(`MlaMoeConfig`), latent attention and routed experts, cut to one
expert-parallel card's share.

Its layer equations are those of DeepSeek-V3's public modeling code
(`model_type` `kimi_k2`, https://huggingface.co/moonshotai/Kimi-K2-Instruct):

    layer ℓ:  h = x + MLA(RMSNorm(x));  out = h + FFN_ℓ(RMSNorm(h))
              (RMSNorm: eps 1e-6, learnable weight, f32 statistics)
    MLA:      cq = RMSNorm_q(x W_qa) [1536];  q = cq W_qb → [64, 128 nope | 64 rope]
              [c_kv | k_pe] = x W_kva → [512 | 64];
              [k_nope | v] = RMSNorm_kv(c_kv) W_kvb → [64, 128 | 128]
              q_pe, k_pe ← RoPE_yarn(pos);  k_pe is one 64-vector per token,
              shared by all 64 heads
              o = softmax(scale · q kᵀ + causal mask) v,
              scale = 192^-½ · (0.1·ln 32 + 1)²;  out = o W_o [8192 → 7168]
    RoPE_yarn: rotate adjacent pairs (2i, 2i+1) by pos·f_i;
              f_i = base^(-2i/64) for i ≤ 19, base^(-2i/64)/32 for i ≥ 20
              (base 50000; the ramp of yarn_find_correction_range(1, 1, 64,
              50000, 4096) = [19, 20]; cos/sin scale 1)
    FFN_0:    dense SwiGLU, width 18432:  (silu(x W_g) ⊙ x W_u) W_d
    FFN_ℓ≥1:  s = sigmoid(f32(x) W_rᵀ) [384];  idx = top8(s + b_corr);
              w = 2.827 · s[idx] / Σ s[idx]
              y = Σ_{i ∈ idx ∩ held} w_i · E_i(x) + E_shared(x);
              E: SwiGLU of width 2048
    loss:     tokens → embedding slice [20480, 7168] → 5 layers → RMSNorm →
              head slice → f32 mean cross-entropy of next ids

The expert layer is told which experts it holds (`experts_held`), routes
every token over all `n_routed_experts`, and computes only its held
experts' part of the result, for the tokens routed to them, with no
capacity limit and no dropped token; on one card it runs with no
exchange. `b_corr` is a buffer the optimizer does not move; there is no
auxiliary loss and no bias update. The embedding and the head are this
card's slice of the vocabulary (`vocab_held` ids).

Rounding points (bf16): the products and the residual stream in the
parameters' type; the norms' statistics, the router, the rotary rotation,
the routed experts' weighting and sum, and the loss in f32. Attention goes
through K3's (192, 128) kernels on a card (`ops/attention.py`) and the
plain chain on the host, as the dense stage's does.

`expert_loads` counts, on the device, the routed slots each held expert
received in each MoE layer; it is read once, when asked.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.ops.attention import (
    attention_reference,
    causal_attention,
)
from kubeoperator_tpu_torch.utils.spans import span


@dataclass(frozen=True)
class MlaMoeConfig:
    """Kimi-K2-Instruct's published widths (its `config.json`), and this
    card's share of an expert-parallel deployment: `experts_held` of the
    `n_routed_experts`, `vocab_held` ids of the vocabulary, and
    `n_dense_layers` + `n_moe_layers` of its 61 layers."""

    hidden: int = 7168
    heads: int = 64
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate: int = 18432          # the dense layers' SwiGLU width
    moe_intermediate: int = 2048       # each expert's SwiGLU width
    n_routed_experts: int = 384
    experts_per_token: int = 8
    n_shared_experts: int = 1
    routed_scaling_factor: float = 2.827
    rope_theta: float = 50000.0
    rope_factor: float = 32.0
    rope_original_max_position: int = 4096
    beta_fast: float = 1.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0
    rms_norm_eps: float = 1e-6
    # the card's share
    n_dense_layers: int = 1
    n_moe_layers: int = 4
    experts_held: tuple[int, ...] = tuple(range(8))
    vocab_held: int = 20480
    b_local: int = 3
    s_local: int = 8192
    dtype: str = "bfloat16"
    init_scale: float = 0.006
    lr: float = 2.2e-4

    @property
    def n_layers(self) -> int:
        return self.n_dense_layers + self.n_moe_layers

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V3's `yarn_get_mscale`."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: MlaMoeConfig) -> float:
    """qk_head_dim^-½ times mscale(factor, mscale_all_dim)²."""
    m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


def rope_frequencies(cfg: MlaMoeConfig) -> torch.Tensor:
    """YaRN's inverse frequencies of the rotated pairs, f32 [rope dim / 2]:
    the extrapolated base^(-2i/d) below the correction range, the
    interpolated base^(-2i/d)/factor above it, a linear ramp across it."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def correction_dim(rotations: float) -> float:
        return d * math.log(cfg.rope_original_max_position
                            / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(cfg.beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    i = torch.arange(d // 2, dtype=torch.float32)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    return extra / cfg.rope_factor * ramp + extra * (1 - ramp)


def rope_tables(cfg: MlaMoeConfig, seq: int, device) -> tuple:
    """(cos, sin) f32 [seq, rope dim / 2] of positions 0..seq-1, times
    YaRN's cos/sin scale mscale(factor, mscale) / mscale(factor, all)."""
    angle = torch.outer(torch.arange(seq, dtype=torch.float32),
                        rope_frequencies(cfg)).to(device)
    m = (yarn_mscale(cfg.rope_factor, cfg.mscale)
         / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    return torch.cos(angle) * m, torch.sin(angle) * m


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [b, s, ..., d] with its adjacent pairs (2i, 2i+1) rotated by the
    angles of `cos`/`sin` [s, d/2], in f32, back in x's type."""
    shape = x.shape
    pairs = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    extra = (1,) * (x.dim() - 3)
    c = cos.reshape(1, shape[1], *extra, -1)
    s_ = sin.reshape(1, shape[1], *extra, -1)
    x0, x1 = pairs[..., 0], pairs[..., 1]
    out = torch.stack((x0 * c - x1 * s_, x0 * s_ + x1 * c), dim=-1)
    return out.reshape(shape).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics, in x's type."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def layer_prefix(i: int) -> str:
    return f"l{i}."


def param_shapes(cfg: MlaMoeConfig) -> dict:
    """{leaf name: (shape, dtype)} in draw order; `step` (the counter) and
    each MoE layer's `b_corr` are the leaves the optimizer does not move."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    d, h = cfg.hidden, cfg.heads
    shapes = {"embed": ((cfg.vocab_held, d), dt)}
    for i in range(cfg.n_layers):
        pre = layer_prefix(i)
        shapes.update({
            pre + "attn_norm": ((d,), dt),
            pre + "wq_a": ((d, cfg.q_lora_rank), dt),
            pre + "q_norm": ((cfg.q_lora_rank,), dt),
            pre + "wq_b": ((cfg.q_lora_rank, h * cfg.qk_head_dim), dt),
            pre + "wkv_a": ((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dt),
            pre + "kv_norm": ((cfg.kv_lora_rank,), dt),
            pre + "wkv_b": ((cfg.kv_lora_rank,
                             h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), dt),
            pre + "wo": ((h * cfg.v_head_dim, d), dt),
            pre + "ffn_norm": ((d,), dt),
        })
        if i < cfg.n_dense_layers:
            f = cfg.intermediate
            shapes.update({pre + "w_gate": ((d, f), dt),
                           pre + "w_up": ((d, f), dt),
                           pre + "w_down": ((f, d), dt)})
        else:
            f, e = cfg.moe_intermediate, len(cfg.experts_held)
            fs = f * cfg.n_shared_experts
            shapes.update({
                pre + "router": ((cfg.n_routed_experts, d), dt),
                pre + "b_corr": ((cfg.n_routed_experts,), torch.float32),
                pre + "experts_gate": ((e, d, f), dt),
                pre + "experts_up": ((e, d, f), dt),
                pre + "experts_down": ((e, f, d), dt),
                pre + "shared_gate": ((d, fs), dt),
                pre + "shared_up": ((d, fs), dt),
                pre + "shared_down": ((fs, d), dt),
            })
    shapes["final_norm"] = ((d,), dt)
    shapes["head"] = ((d, cfg.vocab_held), dt)
    shapes["step"] = ((), torch.float32)
    return shapes


def frozen(cfg: MlaMoeConfig) -> tuple[str, ...]:
    """The leaves no gradient moves."""
    return tuple(k for k in param_shapes(cfg)
                 if k == "step" or k.endswith("b_corr"))


def default_rules():
    """The model's layout: its large matrices cut on fsdp rows (ZeRO-3, as
    the dense stage's wqkv), the router, the norms and `b_corr`
    replicated."""
    return (
        (r"(embed|head|wq_a|wq_b|wkv_a|wkv_b|wo|w_gate|w_up|w_down"
         r"|experts_gate|experts_up|experts_down"
         r"|shared_gate|shared_up|shared_down)$", ("fsdp", None)),
        (r"router$", (None, None)),
        (r"(norm|b_corr)$", (None,)),
    )


def _seed(seed: int, leaf: int) -> int:
    return (seed * 1_000_003 + leaf) % 2 ** 63


def init_params(cfg: MlaMoeConfig, seed: int, device) -> dict:
    """The initial parameters on `device`: each leaf drawn from its own
    `torch.Generator` seeded from (`seed`, its index), in f32, N(0, 1) ×
    init_scale (b_corr: × 1e-3), rounded to its type; norms start at one,
    the step counter at zero."""
    device = torch.device(device)
    out = {}
    for i, (name, (shape, dt)) in enumerate(param_shapes(cfg).items()):
        if name == "step":
            out[name] = torch.zeros((), dtype=dt, device=device)
        elif name.endswith("norm"):
            out[name] = torch.ones(shape, dtype=dt, device=device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed(seed, i))
            t = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            scale = 1e-3 if name.endswith("b_corr") else cfg.init_scale
            out[name] = t.mul_(scale).to(dt)
    return out


def token_batch(cfg: MlaMoeConfig, rows: int, seed: int) -> torch.Tensor:
    """[rows, s_local + 1] int64 token ids, uniform over the vocabulary
    slice, from numpy's `default_rng(seed)`: inputs are [:, :-1], targets
    [:, 1:]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_held, size=(rows, cfg.s_local + 1)))


class ExpertLoads:
    """Routed slots each held expert received in each MoE layer, summed on
    the device by every forward since the last `reset`; `read` copies them
    to the host, [n_moe_layers, experts held] int64 (None before any)."""

    def __init__(self):
        self._slots = None

    def reset(self) -> None:
        self._slots = None

    def add(self, layer: int, n_layers: int, counts: torch.Tensor) -> None:
        if self._slots is None or self._slots.device != counts.device:
            self._slots = torch.zeros((n_layers, counts.numel()),
                                      dtype=torch.int64, device=counts.device)
        self._slots[layer] += counts

    def read(self):
        return None if self._slots is None else self._slots.to("cpu", copy=True)


expert_loads = ExpertLoads()


def _attend(q, k, v, scale):
    # f32 keeps the plain chain on every device; bf16 goes to the fused
    # kernels on a card and to the same plain chain on the host
    if q.dtype == torch.float32:
        return attention_reference(q, k, v, scale)
    return causal_attention(q, k, v, scale)


def mla(x: torch.Tensor, p: dict, pre: str, cfg: MlaMoeConfig,
        rope: tuple) -> torch.Tensor:
    """Multi-head latent attention of normed x [b, s, hidden]."""
    bsz, seq, _ = x.shape
    h, nope, dr = cfg.heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    eps = cfg.rms_norm_eps
    q = (rms_norm(x @ p[pre + "wq_a"], p[pre + "q_norm"], eps)
         @ p[pre + "wq_b"]).view(bsz, seq, h, cfg.qk_head_dim)
    ckv = x @ p[pre + "wkv_a"]
    c, k_pe = torch.split(ckv, [cfg.kv_lora_rank, dr], dim=-1)
    kv = (rms_norm(c, p[pre + "kv_norm"], eps) @ p[pre + "wkv_b"]).view(
        bsz, seq, h, nope + cfg.v_head_dim)
    k_pe = rotate(k_pe, *rope)                        # [b, s, 64], all heads
    q = torch.cat((q[..., :nope], rotate(q[..., nope:], *rope)), dim=-1)
    k = torch.cat((kv[..., :nope], k_pe[:, :, None].expand(bsz, seq, h, dr)),
                  dim=-1)
    o = _attend(q, k, kv[..., nope:], softmax_scale(cfg))
    return o @ p[pre + "wo"]


def route(x: torch.Tensor, router: torch.Tensor, b_corr: torch.Tensor,
          cfg: MlaMoeConfig) -> tuple:
    """(idx [T, k] int64, w [T, k] f32) for tokens x [T, hidden]: selection
    on the sigmoid scores plus b_corr, weights from the scores alone,
    normalised over the selection and scaled."""
    scores = torch.sigmoid(x.float() @ router.float().t())
    idx = torch.topk(scores + b_corr, cfg.experts_per_token, dim=-1,
                     sorted=False).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


class Dispatch(NamedTuple):
    """A MoE layer's routing, its held experts' slot counts on their way to
    the host."""

    w: torch.Tensor           # [T, k] f32 weights
    order: torch.Tensor       # the T·k slots, the held experts' first
    counts: torch.Tensor      # [held] slots each held expert takes (host)
    ready: object             # the copy's event on a card, else None


def dispatch(x: torch.Tensor, p: dict, pre: str, cfg: MlaMoeConfig,
             layer: int = 0) -> Dispatch:
    """Routes tokens x [T, hidden] over all experts and sorts their slots by
    held expert; the counts go to `expert_loads` and, without a wait, to
    the host."""
    held = len(cfg.experts_held)
    with span("moe.route"):
        idx, w = route(x, p[pre + "router"], p[pre + "b_corr"], cfg)
        table = torch.full((cfg.n_routed_experts,), held, dtype=torch.int64,
                           device=x.device)
        table[list(cfg.experts_held)] = torch.arange(held, device=x.device)
        slot = table[idx].flatten()      # a held expert's slot, else `held`
        order = torch.argsort(slot, stable=True)
        counts = torch.bincount(slot, minlength=held + 1)[:held]
        expert_loads.add(layer - cfg.n_dense_layers, cfg.n_moe_layers, counts)
        if not counts.is_cuda:
            return Dispatch(w, order, counts, None)
        host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return Dispatch(w, order, host, ready)


def experts(x: torch.Tensor, d: Dispatch, p: dict, pre: str,
            cfg: MlaMoeConfig) -> torch.Tensor:
    """The held experts' part of the MoE output for tokens x [T, hidden]:
    Σ over each token's selected experts that are held of w_i · E_i(x), in
    f32, cast to x's type. Waits for the counts, the dispatch's one read of
    the device."""
    k = cfg.experts_per_token
    with span("moe.route"):
        if d.ready is not None:
            d.ready.synchronize()
        sizes = d.counts.tolist()
        chosen = d.order[:sum(sizes)]
        xs = x[chosen // k]
        ws = d.w.flatten()[chosen]
    with span("moe.experts"):
        ys, at = [], 0
        for e, n in enumerate(sizes):
            ys.append(swiglu(xs[at:at + n], p[pre + "experts_gate"][e],
                             p[pre + "experts_up"][e],
                             p[pre + "experts_down"][e]))
            at += n
    with span("moe.combine"):
        y = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                        device=x.device)
        y = y.index_add(0, chosen // k, torch.cat(ys).float() * ws[:, None])
    return y.to(x.dtype)


def shared(x: torch.Tensor, p: dict, pre: str) -> torch.Tensor:
    with span("moe.shared"):
        return swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"],
                      p[pre + "shared_down"])


def ffn(x: torch.Tensor, p: dict, i: int, cfg: MlaMoeConfig) -> torch.Tensor:
    """Layer i's FFN of normed x [b, s, hidden]: dense SwiGLU in the leading
    dense layers, routed plus shared experts after them."""
    pre = layer_prefix(i)
    if i < cfg.n_dense_layers:
        return swiglu(x, p[pre + "w_gate"], p[pre + "w_up"], p[pre + "w_down"])
    flat = x.reshape(-1, x.shape[-1])
    # the shared expert runs on the card while the counts come to the host
    d = dispatch(flat, p, pre, cfg, i)
    y_shared = shared(flat, p, pre)
    return (experts(flat, d, p, pre, cfg) + y_shared).view(x.shape)


def hidden(p: dict, ids: torch.Tensor, cfg: MlaMoeConfig) -> torch.Tensor:
    """The residual stream after every layer, for token ids [b, s]."""
    x = F.embedding(ids, p["embed"])
    rope = rope_tables(cfg, ids.shape[1], ids.device)
    eps = cfg.rms_norm_eps
    for i in range(cfg.n_layers):
        pre = layer_prefix(i)
        with span("block.attention"):
            x = x + mla(rms_norm(x, p[pre + "attn_norm"], eps), p, pre, cfg,
                        rope)
        with span("block.ffn"):
            x = x + ffn(rms_norm(x, p[pre + "ffn_norm"], eps), p, i, cfg)
    return x


def logits_of(p: dict, x: torch.Tensor, cfg: MlaMoeConfig) -> torch.Tensor:
    return rms_norm(x, p["final_norm"], cfg.rms_norm_eps) @ p["head"]


def forward(p: dict, ids: torch.Tensor, cfg: MlaMoeConfig) -> torch.Tensor:
    """Logits [b, s, vocab_held] of token ids [b, s]."""
    x = hidden(p, ids, cfg)
    with span("model.head"):
        return logits_of(p, x, cfg)


def loss_sum(p: dict, batch: torch.Tensor, cfg: MlaMoeConfig) -> torch.Tensor:
    """The f32 sum over this rank's rows of the cross-entropy of each next
    id, for a [rows, s + 1] batch of ids."""
    x = hidden(p, batch[:, :-1], cfg)
    with span("model.head"):
        logits = logits_of(p, x, cfg).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch[:, 1:].reshape(-1), reduction="sum")


def step_flops(cfg: MlaMoeConfig, tokens: int) -> float:
    """Model FLOPs of one training step over `tokens` tokens: products at
    2·m·n·k with the routed experts at their expected load (tokens · k ·
    held / experts), attention over the causal half of each row, backward
    as twice the forward; the embedding's look-up is no product."""
    d, h = cfg.hidden, cfg.heads
    seq = cfg.s_local
    per_token_mla = (d * cfg.q_lora_rank + cfg.q_lora_rank * h * cfg.qk_head_dim
                     + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                     + cfg.kv_lora_rank * h * (cfg.qk_nope_head_dim
                                               + cfg.v_head_dim)
                     + h * cfg.v_head_dim * d)
    expert = 3 * d * cfg.moe_intermediate
    load = cfg.experts_per_token * len(cfg.experts_held) / cfg.n_routed_experts
    per_token_moe = (cfg.n_routed_experts * d + expert * load
                     + expert * cfg.n_shared_experts)
    params = (cfg.n_layers * per_token_mla
              + cfg.n_dense_layers * 3 * d * cfg.intermediate
              + cfg.n_moe_layers * per_token_moe + d * cfg.vocab_held)
    # multiply-adds a token: q·kᵀ and P·v over the causal half of its row
    attention = cfg.n_layers * h * seq / 2 * (cfg.qk_head_dim + cfg.v_head_dim)
    return 3.0 * 2.0 * tokens * (params + attention)
