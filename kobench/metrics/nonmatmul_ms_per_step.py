"""nonmatmul_ms_per_step: device time per step and card of every kernel,
copy and fill outside the matmul and NCCL classes (`kobench/trace.py`)."""


def read(layer: dict):
    trace = layer.get("trace")
    if not trace or not trace["kernel_s"] or not layer.get("steps"):
        return None
    return 1e3 * trace["other_s"] / trace["ranks"] / layer["steps"]
