"""Layers and optimizers both plain references share."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

STATE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def rms(h: torch.Tensor) -> torch.Tensor:
    return h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6)


def causal_attention(qkv: torch.Tensor, heads: int, mm) -> torch.Tensor:
    """Causal softmax attention of a [rows, seq, 3d] projection, scaled by
    1/sqrt(head dim); [rows, seq, d]."""
    rows, seq, three_d = qkv.shape
    d = three_d // 3
    dh = d // heads
    q, k, v = (t.reshape(rows, seq, heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    keep = torch.ones(seq, seq, dtype=torch.bool, device=qkv.device).tril()
    logits = logits.masked_fill(~keep, float("-inf"))
    att = mm(torch.softmax(logits, dim=-1), v)
    return att.transpose(1, 2).reshape(rows, seq, d)


def ffn(h: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, mm):
    return mm(F.gelu(mm(rms(h), w_in), approximate="tanh"), w_out)


def loss_and_grads(params: dict, rows_of, n_rows: int, block: int,
                   loss_of) -> tuple[float, dict]:
    """The summed loss and its gradients over the batch, `block` rows at a
    time: ``rows_of(i, j)`` gives rows i..j as float32, ``loss_of(p, x, i)``
    the loss of those rows (i: the first row's index)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = 0.0
    for i in range(0, n_rows, block):
        x = rows_of(i, min(i + block, n_rows))
        loss = loss_of(leaves, x, i)
        parts = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        for k, g in zip(leaves, parts):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads


def train(p0: dict, loss_and_grads_of, opt: dict, steps: int,
          state_dtype: str) -> dict:
    """`steps` optimizer steps from `p0` in float32, the parameters rounded
    to the configuration's state type after each update. Returns each
    step's loss, the first gradient and the parameters after step 1 and
    after the last step."""
    keep = STATE_DTYPES[state_dtype]
    p = {k: v.float() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, out = [], {}
    for t in range(1, steps + 1):
        loss, g = loss_and_grads_of(p)
        losses.append(loss)
        if t == 1:
            out["grad1"] = g
        with torch.no_grad():
            for k in p:
                if opt["kind"] == "sgd":
                    new = p[k] - opt["lr"] * g[k]
                else:
                    mu[k] = opt["b1"] * mu[k] + (1 - opt["b1"]) * g[k]
                    nu[k] = opt["b2"] * nu[k] + (1 - opt["b2"]) * g[k] * g[k]
                    m_hat = mu[k] / (1 - opt["b1"] ** t)
                    n_hat = nu[k] / (1 - opt["b2"] ** t)
                    u = m_hat / (torch.sqrt(n_hat) + opt["eps"]) \
                        + opt["weight_decay"] * p[k]
                    new = p[k] - opt["lr"] * u
                p[k] = new.to(keep).float()
        if t == 1:
            out["params1"] = {k: v.clone() for k, v in p.items()}
    out["losses"] = losses
    out["params"] = p
    return out
