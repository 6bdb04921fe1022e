"""Tensor-core sustained-throughput check.

Counterpart of `kubeoperator_tpu/ops/matmul.py::mxu_matmul_tflops`: chained
bf16 [size, size] products with f32 accumulation, timed differentially,
compared by `koctl tpu diag` against the part's data-sheet bf16 rate to
flag a degraded card. A plain large product, so it is `torch.matmul`, as
the reference leaves it to XLA.

The chain step. The reference computes `dot(v, w)` in f32, scales by
1/size in f32 and casts to bf16. Here the scale is folded into the
weights once (`w * (1/size)`), so each step is one product whose f32
accumulator is rounded to bf16 once. For a power-of-two `size` this is
the same function: scaling by 2^-k is exact in f32 and in bf16, so every
product term, the f32 sum and its single rounding are the reference's
scaled by 2^-k (values that fall into the subnormal range excepted).

Protocol, as in the reference: lo=iters, hi=4*iters, `trials` draws,
MEDIAN as the estimate, the min-max band reported beside it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from statistics import median

import torch

from kubeoperator_tpu_torch.utils.device import resolve_device


def _round_tflops(v: float) -> float:
    """1-decimal readability at card scale, but keep sub-0.05 host-side
    readings nonzero (round(v, 1) == 0.0 would erase a real measurement)."""
    return round(v, 1) if v >= 1.0 else round(v, 4)


@dataclass(frozen=True)
class MatmulResult:
    size: int
    dtype: str
    iters: int
    time_s: float
    tflops: float                      # median-of-trials estimate
    tflops_band: tuple = ()            # (min, max) across trials
    trials: tuple = ()                 # per-trial TFLOP/s draws

    @property
    def band_pct(self) -> float:
        """Band width as % of the median."""
        if not self.tflops_band or self.tflops <= 0:
            return 0.0
        lo, hi = self.tflops_band
        return (hi - lo) / self.tflops * 100.0

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["tflops_band"] = list(self.tflops_band)
        d["trials"] = list(self.trials)
        d["band_pct"] = round(self.band_pct, 1)
        return d


def mxu_matmul_tflops(
    size: int = 4096,
    iters: int = 30,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
    trials: int = 7,
) -> MatmulResult:
    """Sustained TFLOP/s of chained [size,size] matmuls on one device.
    The returned .tflops is the MEDIAN of `trials` differential draws."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        # host runs are for tests: a 4096^2 chain is minutes on a CPU
        size = min(size, 512)
        iters = min(iters, 4)
        trials = min(trials, 3)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((size, size), generator=gen).to(dev, dtype)
    w = torch.randn((size, size), generator=gen).mul_(1.0 / size).to(dev, dtype)
    bufs = (torch.empty_like(a), torch.empty_like(a))

    def run(n: int) -> float:
        v = a
        for i in range(n):
            v = torch.matmul(v, w, out=bufs[i % 2])
        return float(v.float().sum().item())  # scalar readback

    lo, hi = max(iters, 1), max(iters, 1) * 4
    run(lo)
    run(hi)  # warm both paths before any timing
    flops = 2.0 * size * size * size
    draws = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run(lo)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(hi)
        t_hi = time.perf_counter() - t0
        dt = max((t_hi - t_lo) / (hi - lo), 1e-9)
        draws.append(flops / dt / 1e12)
    est = median(draws)
    return MatmulResult(
        size=size, dtype=str(dtype).removeprefix("torch."), iters=iters,
        time_s=flops / est / 1e12, tflops=_round_tflops(est),
        tflops_band=(_round_tflops(min(draws)), _round_tflops(max(draws))),
        trials=tuple(_round_tflops(d) for d in draws),
    )
