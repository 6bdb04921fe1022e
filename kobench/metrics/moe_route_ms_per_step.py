"""moe_route_ms_per_step: device time a step of the kernels put down to the
`ko.moe.route` and `ko.moe.combine` spans (`kobench/spans.py`): the router
product, sigmoid, top-k, weights, the permutation of tokens to the held
experts and the weighted scatter back, with their backward kernels."""

SPANS = ("ko.moe.route", "ko.moe.combine")


def read(layer: dict):
    summary = layer.get("spans")
    found = [summary["spans"][s] for s in SPANS
             if summary and s in summary["spans"]]
    if not found or not summary["busy_s"] or not layer.get("steps"):
        return None
    return 1e3 * sum(f["device_s"] for f in found) / layer["steps"]
