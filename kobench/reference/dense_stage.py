"""Plain reference of the tenant workload's dense stage: rms-norm, causal
multi-head attention, a tanh-gelu FFN, a readout, the loss sum(y²) over
the global batch divided by its size, and AdamW.

The batch of a training cell is the one the training entry feeds: numpy's
``default_rng(seed + 1)`` standard normal of [global batch, seq, d_model],
rounded through float32 to the configuration's type. This module draws it
again itself.
"""

from __future__ import annotations

import numpy as np
import torch

from kobench.reference.common import (STATE_DTYPES, causal_attention, ffn,
                                      loss_and_grads, rms, train)


def weight_shapes(cfg: dict) -> dict:
    d, f = cfg["d_model"], cfg["d_ff"]
    return {"wqkv": (d, 3 * d), "w_in": (d, f), "w_out": (f, d),
            "w_head": (d, d)}


def global_batch(cfg: dict) -> int:
    mesh = cfg["mesh"]
    return cfg["b_local"] * mesh["data"] * mesh["fsdp"]


def entry_batch(cfg: dict, seed: int, device) -> torch.Tensor:
    """The training entry's batch for `seed`, drawn again, in the
    configuration's type on `device`."""
    shape = (global_batch(cfg), cfg["s_local"], cfg["d_model"])
    host = np.random.default_rng(seed + 1).standard_normal(shape)
    return torch.from_numpy(host.astype(np.float32)).to(device).to(
        STATE_DTYPES[cfg["dtype"]])


def forward(p: dict, x: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """y for float32 rows x [rows, seq, d_model]."""
    h = x + causal_attention(mm(rms(x), p["wqkv"]), cfg["heads"], mm)
    h = h + ffn(h, p["w_in"], p["w_out"], mm)
    return mm(h, p["w_head"])


def serve(p: dict, x: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """The forward of a whole request, `reference_rows` rows at a time,
    in float32."""
    p = {k: v.float() for k, v in p.items()}
    block = cfg["reference_rows"]
    with torch.no_grad():
        return torch.cat([forward(p, x[i:i + block].float(), cfg, mm)
                          for i in range(0, x.shape[0], block)])


def train_steps(p0: dict, x: torch.Tensor, cfg: dict, steps: int, mm) -> dict:
    """`steps` AdamW steps of the loss over the batch x (see `common.train`)."""
    denom = float(x.shape[0] * x.shape[1] * x.shape[2])

    def loss_of(p, rows, _first):
        y = forward(p, rows, cfg, mm)
        return torch.sum(y * y) / denom

    def grads_of(p):
        return loss_and_grads(p, lambda i, j: x[i:j].float(), x.shape[0],
                              cfg["reference_rows"], loss_of)

    return train(p0, grads_of, cfg["optimizer"], steps, cfg["dtype"])
