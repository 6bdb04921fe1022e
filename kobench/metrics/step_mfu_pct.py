"""step_mfu_pct: the whole training step's share of the cards' bf16 peak:
the benchmark's frozen FLOPs of one global step (`kobench/flops.py`) times
the window's steps, over the window's host-clock time, the cards used and
the peak of `kobench/peaks.py`."""


def read(layer: dict):
    peak = layer.get("peak_flops")
    if not peak or not layer.get("steps"):
        return None
    return 100.0 * layer["step_flops"] * layer["steps"] / (
        layer["window_s"] * layer["chips"] * peak)
