"""entry_host_ms_per_step: the host's own work of enqueuing one step of
the training entry, a step: the host time of its `ko.train.step` span (the
call of the step function to its return) less the blocked time of the
CUDA runtime calls made during it on any thread (`kobench/spans.py`):
each call's wait beyond its unblocked cost, which the host spends waiting
for room in the launch queue whenever it runs ahead. The launches' own
cost stays in. The step time less this is the host's headroom."""

SPAN = "ko.train.step"


def read(layer: dict):
    summary = layer.get("spans")
    found = summary["spans"].get(SPAN) if summary else None
    if not found or not layer.get("steps"):
        return None
    return 1e3 * (found["host_s"] - found["blocked_s"]) / layer["steps"]
