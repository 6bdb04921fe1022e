"""comm_ms_per_step: device time of NCCL kernels per step and card, from
the profiler's trace of the window."""


def read(layer: dict):
    trace = layer.get("trace")
    if not trace or not trace["nccl_s"] or not layer.get("steps"):
        return None
    return 1e3 * trace["nccl_s"] / trace["ranks"] / layer["steps"]
