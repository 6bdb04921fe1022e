"""moe_experts_ms_per_step: device time a step of the kernels put down to
the `ko.moe.experts` span (`kobench/spans.py`): the held experts' products
on the tokens routed to them, with their backward kernels."""

SPAN = "ko.moe.experts"


def read(layer: dict):
    summary = layer.get("spans")
    found = summary["spans"].get(SPAN) if summary else None
    if not found or not summary["busy_s"] or not layer.get("steps"):
        return None
    return 1e3 * found["device_s"] / layer["steps"]
