"""optimizer_ms_per_step: device time a step of the kernels launched inside
the `ko.step.optimizer` span (`kobench/spans.py`): AdamW's update of every
leaf and the step counter."""

SPAN = "ko.step.optimizer"


def read(layer: dict):
    summary = layer.get("spans")
    found = summary["spans"].get(SPAN) if summary else None
    if not found or not summary["busy_s"] or not layer.get("steps"):
        return None
    return 1e3 * found["device_s"] / layer["steps"]
