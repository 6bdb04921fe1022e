"""The tenant workload's first model: the validation net's dense stage
(`NetConfig`) with the reference's rounding points, behind the step's model
seam (`workloads/step.py::MODELS`).

    y = (h + gelu(rms(h) W_in) W_out) W_head,  h = x + attention(rms(x) W_qkv)

rms squares in x's type; attention is `ops/attention.py::causal_attention`
over d_model / heads wide heads; tanh gelu; the loss sum(y²) over every
output entry, as a mean (`loss_count`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.ops.attention import causal_attention, unbuilt_widths
from kubeoperator_tpu_torch.parallel.comm import psum, replicate
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig, rms
from kubeoperator_tpu_torch.utils.spans import span
from kubeoperator_tpu_torch.weights import from_f64

ADAMW_LR = 1e-2     # NetConfig.lr is the validation net's SGD step


def default_rules():
    """The model's layout as ordered (regex, spec) rules, first match wins."""
    return (
        (r"wqkv$", ("fsdp", None)),        # ZeRO-3: rows sharded on fsdp
        (r"w_in$", (None, "tp")),          # megatron col-parallel
        (r"w_out$", ("tp", None)),         # megatron row-parallel
        (r"w_head$", (None, None)),        # replicated readout
    )


def param_shapes(cfg: NetConfig) -> dict:
    """{leaf name: (shape, dtype)} in the reference's draw order. The
    non-trainable scalar `step` rides the tree on purpose: the rule
    engine's scalar exemption is part of the workload contract."""
    d, f = cfg.d_model, cfg.d_ff
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"wqkv": ((d, 3 * d), dt), "w_in": ((d, f), dt),
            "w_out": ((f, d), dt), "w_head": ((d, d), dt),
            "step": ((), torch.float32)}


def frozen(cfg: NetConfig) -> tuple[str, ...]:
    return ("step",)


def adamw_lr(cfg: NetConfig) -> float:
    return ADAMW_LR


def init_params(cfg: NetConfig, seed: int, device) -> dict:
    """The initial parameters on `device`, drawn on the host from numpy's
    `default_rng(seed)` in draw order, N(0, 1) × 0.05."""
    rng = np.random.default_rng(seed)
    out = {name: from_f64(rng.standard_normal(shape) * 0.05, cfg.dtype)
           for name, (shape, _) in param_shapes(cfg).items()
           if name != "step"}
    out["step"] = torch.zeros((), dtype=torch.float32)
    return {k: t.to(device) for k, t in out.items()}


def host_batch(cfg: NetConfig, rows: int, seed: int) -> torch.Tensor:
    """[rows, s_local, d_model] inputs from numpy's `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    return from_f64(rng.standard_normal((rows, cfg.s_local, cfg.d_model)),
                    cfg.dtype)


def attention_unbuilt(cfg: NetConfig) -> str | None:
    dh = cfg.d_model // cfg.heads
    return unbuilt_widths(dh, dh, scaled=False)


def forward(p: dict, x: torch.Tensor, cfg: NetConfig, tp=None) -> torch.Tensor:
    """The dense stage on whole weights (w_in / w_out: this rank's tp blocks
    when `tp`, the group they are cut over, is given)."""
    d, h = cfg.d_model, cfg.heads
    bsz, seq = x.shape[0], x.shape[1]
    with span("block.attention"):
        qkv = rms(x) @ p["wqkv"]
        q, k, v = (t.reshape(bsz, seq, h, d // h)
                   for t in torch.split(qkv, d, dim=-1))
        hx = x + causal_attention(q, k, v)
    with span("block.ffn"):
        f_in = rms(hx)
        if tp is not None:
            f_in = replicate(f_in, tp)
        ff = F.gelu(f_in @ p["w_in"], approximate="tanh") @ p["w_out"]
        if tp is not None:
            ff = psum(ff, tp)
        hx = hx + ff
    return hx @ p["w_head"]


def loss_sum(p: dict, batch: torch.Tensor, cfg: NetConfig,
             tp=None) -> torch.Tensor:
    y = forward(p, batch, cfg, tp).float()
    return torch.sum(y * y)


def loss_count(cfg: NetConfig, rows: int) -> float:
    return float(rows * cfg.s_local * cfg.d_model)


def step_flops(cfg: NetConfig, tokens: int) -> float:
    """Products at 2·m·n·k, full-matrix attention per the standard MFU
    convention, backward as twice the forward."""
    s, d, f = cfg.s_local, cfg.d_model, cfg.d_ff
    fwd = tokens * (
        6 * d * d          # qkv projection [d -> 3d]
        + 4 * s * d        # attention: qk^T + av
        + 2 * d * f        # FFN in
        + 2 * f * d        # FFN out
        + 2 * d * d        # readout head
    )
    return 3.0 * fwd
