"""device_idle_pct.serve: the share of in-service time (each request from
the start of its service to its answer on the host) in which no kernel,
copy or fill runs. Time between requests is load, not program, and is
left out."""


def read(layer: dict):
    trace = layer.get("trace")
    if not trace or not trace["span_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_in_spans_s"] / trace["span_s"])
