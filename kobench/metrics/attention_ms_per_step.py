"""attention_ms_per_step: device time a step of the kernels put down to the
`ko.block.attention` span (`kobench/spans.py`): attention's forward
kernels and the backward kernels of its forward ops."""

SPAN = "ko.block.attention"


def read(layer: dict):
    summary = layer.get("spans")
    found = summary["spans"].get(SPAN) if summary else None
    if not found or not summary["busy_s"] or not layer.get("steps"):
        return None
    return 1e3 * found["device_s"] / layer["steps"]
