"""The training window of `train_dense`, with the trace attributed to the
program's own spans.

The run is `kobench.drivers.train_dense`'s, unchanged: one call of the
tenant's `run_training`, its checked steps as set-up, the window, then the
reference. When traced, the profiler that driver builds is kept, and its
trace is also put down to the port's ``ko.*`` ranges (`kobench/spans.py`):
``layer["spans"]`` holds each span's device time, host time and count,
and the breakdown's idle gaps are named ``<span>/<host op>``. A program
that records no ``ko.*`` range gives no span, and the metrics that read
them stay silent.
"""

from __future__ import annotations

import sys

from kobench import compare, spans as spanning
from kobench.drivers import train_dense


def program_run(cell, seed: int, seconds: float, trace: bool, device: str,
                fault: str | None = None) -> tuple[dict, dict]:
    """`train_dense.program_run`, with ``layer["spans"]`` when traced."""
    made = []
    build = train_dense._profiler

    def keep(dev_type: str):
        made.append(build(dev_type))
        return made[-1]

    train_dense._profiler = keep
    try:
        outcome, prog = train_dense.program_run(cell, seed, seconds, trace,
                                                device, fault)
    finally:
        train_dense._profiler = build
    if made:
        layer = outcome["layer"]
        summary = spanning.summarize(*spanning.from_profiler(made[0]))
        layer["spans"] = summary
        layer["trace"]["idle_gaps"] = summary["idle_gaps"]
        steps = max(layer["steps"], 1)
        for name, s in sorted(summary["spans"].items()):
            print(f"kobench: span {name} device {1e3 * s['device_s'] / steps!r} "
                  f"ms/step host {1e3 * s['host_s'] / steps!r} ms/step "
                  f"of which runtime calls {1e3 * s['runtime_s'] / steps!r} "
                  f"blocked {1e3 * s['blocked_s'] / steps!r} "
                  f"count {s['count']}", file=sys.stderr)
        print(f"kobench: span none device "
              f"{1e3 * summary['unclaimed_s'] / steps!r} ms/step of busy "
              f"{1e3 * summary['busy_s'] / steps!r}", file=sys.stderr)
    return outcome, prog


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: str | None = None) -> dict:
    outcome, prog = program_run(cell, seed, seconds, trace, device, fault)
    outcome["readings"] = compare.train_readings(
        prog, train_dense.reference_outputs(cell, seed, train_dense._device(device)))
    return outcome


control = train_dense.control
