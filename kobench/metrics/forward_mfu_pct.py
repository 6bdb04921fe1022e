"""forward_mfu_pct: one request's forward FLOPs (`kobench/flops.py`) over
the median service time and the card's bf16 peak (`kobench/peaks.py`)."""

import statistics


def read(layer: dict):
    peak = layer.get("peak_flops")
    service = layer.get("service_s")
    if not peak or not service:
        return None
    return 100.0 * layer["forward_flops"] / (statistics.median(service) * peak)
