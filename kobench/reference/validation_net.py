"""Plain reference of the validation net's global training step, on one
device: the sharded step's ring attention is causal attention over the
whole sequence, its Megatron FFN is the whole FFN, its MoE all-to-all is
each token going to its expert, and its SGD update is one subtraction.

Routing is static, as the configuration states: within each sequence
shard, the i-th token of the shard's rows (row-major over rows and
positions) goes to expert ``i mod n_exp``, n_exp = sp, and its output is
scaled by the gate's softmax weight of that expert. One pipeline stage
(pp = 1) is modelled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kobench.reference.common import causal_attention, ffn, loss_and_grads, rms, train


def weight_shapes(cfg: dict) -> dict:
    mesh = cfg["mesh"]
    pp, n_exp = mesh["pp"], mesh["sp"]
    d, f = cfg["d_model"], cfg["d_ff"]
    return {"wqkv": (pp, d, 3 * d), "w_in": (pp, d, f), "w_out": (pp, f, d),
            "w_gate": (pp, d, n_exp), "w_exp": (pp, n_exp, d, d),
            "w_head": (d, d)}


def batch_shape(cfg: dict) -> tuple[int, int, int]:
    mesh = cfg["mesh"]
    return (cfg["b_local"] * mesh["dp"], cfg["s_local"] * mesh["sp"],
            cfg["d_model"])


def expert_of(cfg: dict, first_row: int, rows: int, seq: int, device):
    """[rows, seq] expert index of each token."""
    b_local, s_local = cfg["b_local"], cfg["s_local"]
    n_exp = cfg["mesh"]["sp"]
    row = (torch.arange(first_row, first_row + rows, device=device)
           % b_local)[:, None]
    pos = (torch.arange(seq, device=device) % s_local)[None, :]
    return (row * s_local + pos) % n_exp


def forward(p: dict, x: torch.Tensor, cfg: dict, mm, first_row: int):
    """y for float32 rows x [rows, seq, d_model] starting at `first_row`."""
    if cfg["mesh"]["pp"] != 1:
        raise ValueError("the reference models one pipeline stage (pp = 1)")
    rows, seq, d = x.shape
    h = x + causal_attention(mm(rms(x), p["wqkv"][0]), cfg["heads"], mm)
    h = h + ffn(h, p["w_in"][0], p["w_out"][0], mm)
    t = rms(h)
    gate = torch.softmax(mm(t, p["w_gate"][0]), dim=-1)
    expert = expert_of(cfg, first_row, rows, seq, x.device)
    moe = torch.zeros_like(t)
    for e in range(gate.shape[-1]):
        sel = expert == e
        out = F.gelu(mm(t[sel], p["w_exp"][0, e]), approximate="tanh")
        moe = moe.index_put((sel.nonzero(as_tuple=True)),
                            gate[..., e][sel][:, None] * out)
    return mm(h + moe, p["w_head"])


def train_steps(p0: dict, x: torch.Tensor, cfg: dict, steps: int, mm) -> dict:
    """`steps` SGD steps of the global loss over the batch x."""
    denom = float(x.shape[0] * x.shape[1] * x.shape[2] * cfg["mesh"]["pp"])

    def loss_of(p, rows, first):
        y = forward(p, rows, cfg, mm, first)
        return torch.sum(y * y) / denom

    def grads_of(p):
        return loss_and_grads(p, lambda i, j: x[i:j].float(), x.shape[0],
                              cfg["reference_rows"], loss_of)

    return train(p0, grads_of, cfg["optimizer"], steps, cfg["dtype"])
