"""Differential device timing (a copy of `kubeoperator_tpu/ops/timing.py`).

Time the same computation at two iteration counts and divide the
difference by the count difference, so the constant cost of a call
(launch, readback) cancels:

    t_per_iter = (t(hi) - t(lo)) / (hi - lo)

CUDA launches are asynchronous: `run(n)` must end in a scalar `.item()`
readback, which waits for every launch before it on the stream.
Runs `trials` rounds and takes the median delta for noise robustness.
"""

from __future__ import annotations

import time
from statistics import median
from typing import Callable


def differential_time_per_iter(
    run: Callable[[int], object],
    lo: int,
    hi: int,
    trials: int = 3,
) -> float:
    """`run(iters)` must execute iters chained device iterations and block on
    a scalar readback. Returns seconds per iteration (>= 1ns)."""
    if hi <= lo:
        raise ValueError("hi must exceed lo")
    # warm both paths (allocator, kernel loading) before any timing
    run(lo)
    run(hi)
    deltas = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run(lo)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(hi)
        t_hi = time.perf_counter() - t0
        deltas.append((t_hi - t_lo) / (hi - lo))
    return max(median(deltas), 1e-9)
