"""Frozen operation counts of the Kimi-K2 cell (`configs/kimi-k2-ep48.json`).

`step_flops` is a copy of `kubeoperator_tpu_torch/workloads/mla_moe.py::
step_flops` as it stands when the cell was defined, taking the
configuration file's keys: products at 2·m·n·k, the routed experts at
their expected load (tokens · k · held / experts), attention over the
causal half of each row, backward counted as twice the forward,
recomputation not counted; the embedding's look-up is no product.

`k3_operations` is what K3's latent-width kernels must execute in one
step, as PERF.md's K3 bound convention counts it: the causal half of each
product, forward q·kᵀ at 192 columns and P·v at 128, backward two of each
width (dO·vᵀ and Pᵀ·dO at 128, dS·k and dSᵀ·q at 192), no recomputation.
"""

from __future__ import annotations


def _tokens(cfg: dict) -> int:
    mesh = cfg["mesh"]
    return cfg["b_local"] * mesh["data"] * mesh["fsdp"] * cfg["s_local"]


def step_flops(cfg: dict) -> float:
    """One global training step."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    dense = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    router = cfg["deployment"]["router_width"]
    held = len(cfg["deployment"]["experts_held"])
    per_token_mla = (d * cfg["q_lora_rank"] + cfg["q_lora_rank"] * h * qk
                     + d * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
                     + cfg["kv_lora_rank"] * h * (cfg["qk_nope_head_dim"] + dv)
                     + h * dv * d)
    expert = 3 * d * cfg["moe_intermediate_size"]
    load = cfg["num_experts_per_tok"] * held / router
    per_token_moe = router * d + expert * load + expert * cfg["n_shared_experts"]
    params = (layers * per_token_mla + dense * 3 * d * cfg["intermediate_size"]
              + (layers - dense) * per_token_moe + d * cfg["vocab_size"])
    attention = layers * h * cfg["s_local"] / 2 * (qk + dv)
    return 3.0 * 2.0 * _tokens(cfg) * (params + attention)


def k3_operations(cfg: dict) -> float:
    """K3's operations in one global step (module docstring)."""
    s, h = cfg["s_local"], cfg["num_attention_heads"]
    rows = _tokens(cfg) // s
    width = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    unit = rows * h * s * (s + 1)           # 2 · the causal half of s², a row
    return float(cfg["num_hidden_layers"] * 3 * unit * width)
