"""The numbers that decide `correct`, from the program's outputs and the
plain reference's.

Training (the first steps that set-up drives through the window's own
call): each step's loss as a relative gap; the first gradient as the
optimizer got it, and the parameters' change after the checked steps, each
by its worst leaf. A leaf's gap is |‖program‖ − ‖reference‖| (``*_gap``)
or ‖program − reference‖ (``*_err``), over the larger of the reference
leaf's norm and the median leaf's. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out.

Serving: every answer's digest against the reference's digest of the same
input, and chosen rows of a sample of answers, token by token.
"""

from __future__ import annotations

import math
import statistics

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone
QUIET_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def _worst_leaf(prog: dict, ref: dict, kept: list, diff: bool) -> float:
    ref_norms = {k: _norm(ref[k]) for k in kept}
    med = statistics.median(ref_norms.values())
    worst = 0.0
    for k in kept:
        p = prog[k].to(ref[k].device)
        if diff:
            num = _norm(p.double() - ref[k].double())
        else:
            num = abs(_norm(p) - ref_norms[k])
        den = max(ref_norms[k], med)
        worst = max(worst, num / den if den else (0.0 if num == 0 else math.inf))
    return worst if math.isfinite(worst) else math.inf


def moving_leaves(ref_grad: dict) -> list:
    """The leaves the reference's first gradient moves (module docstring)."""
    norms = {k: _norm(g) for k, g in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= QUIET_LEAF * med]


def train_readings(prog: dict, ref: dict) -> dict:
    """prog and ref each hold ``losses`` (one per checked step), ``grad1``
    (the first gradient as the optimizer got it) and ``change`` (the
    parameters after the checked steps minus the initial ones), the
    tensors keyed by leaf."""
    kept = moving_leaves(ref["grad1"])
    out = {f"loss{t + 1}_gap": _rel(p, r)
           for t, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    out["grad1_gap"] = _worst_leaf(prog["grad1"], ref["grad1"], kept, False)
    out["grad1_err"] = _worst_leaf(prog["grad1"], ref["grad1"], kept, True)
    out["change_gap"] = _worst_leaf(prog["change"], ref["change"], kept, False)
    out["change_err"] = _worst_leaf(prog["change"], ref["change"], kept, True)
    return out


def digest(y: torch.Tensor) -> float:
    """sum(y²) / y.numel() in float64: the serve verb's answer read."""
    return float(torch.sum(y.double() ** 2) / y.numel())


def token_err(shape, y: torch.Tensor, ref: torch.Tensor, rows) -> float:
    """The widest relative gap of one token's output vector over the rows
    `rows` of an answer of shape `shape`, which `y` holds; an answer of
    another shape than the reference's lacks rows or tokens and reads 1."""
    if tuple(shape) != tuple(ref.shape):
        return 1.0
    r = ref[list(rows)].double()
    err = torch.linalg.vector_norm(y.double() - r, dim=-1)
    worst = float((err / torch.linalg.vector_norm(r, dim=-1).clamp(min=1e-30)).max())
    return worst if math.isfinite(worst) else math.inf
