"""The serving window of `serve_dense` under bursts of arrivals.

The run is `serve_dense`'s, unchanged but for the due times: the mean rate
of the traffic file comes in on/off phases. Each `period_s` opens with
`burst_s` at `burst_factor` times the rate, the rest at `quiet_factor`
times it; the first burst starts `first_burst_s` into the window, a fixed
phase. Within each phase the arrivals are a fixed sample of a Poisson
stream (the traffic file's ``arrival_seed``), given its count as
`serve_dense` gives the whole window its own: rate × length arrival times,
uniform over the phase. Every seed so offers the same load.
"""

from __future__ import annotations

import numpy as np

from kobench.drivers import serve_dense

control = serve_dense.control


def phases(traffic: dict, seconds: float) -> list[tuple[float, float, float]]:
    """(start, end, rate) of each phase within [0, seconds)."""
    period, burst = traffic["period_s"], traffic["burst_s"]
    rate = traffic["rate_per_s"]
    edges = {0.0, float(seconds)}
    start = traffic["first_burst_s"] - period * np.ceil(traffic["first_burst_s"] / period)
    while start < seconds:
        edges.update(t for t in (start, start + burst) if 0 < t < seconds)
        start += period
    edges = sorted(edges)
    out = []
    for a, b in zip(edges, edges[1:]):
        into = (a - traffic["first_burst_s"]) % period
        factor = traffic["burst_factor"] if into < burst else traffic["quiet_factor"]
        out.append((a, b, rate * factor))
    return out


def arrivals(traffic: dict, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of the bursty stream."""
    rng = np.random.default_rng(traffic["arrival_seed"])
    due = [rng.uniform(a, b, size=round(rate * (b - a)))
           for a, b, rate in phases(traffic, seconds)]
    return np.sort(np.concatenate(due))


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: str | None = None) -> dict:
    """`serve_dense.run` with the bursty due times."""
    steady = serve_dense.arrivals
    serve_dense.arrivals = lambda rate, secs, arrival_seed: arrivals(
        cell.traffic, secs)
    try:
        return serve_dense.run(cell, seed, seconds, trace, device, fault)
    finally:
        serve_dense.arrivals = steady
