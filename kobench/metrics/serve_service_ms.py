"""serve_service_ms: median time from a request's start of service to its
answer on the host; queueing is left out."""

import statistics


def read(layer: dict):
    service = layer.get("service_s")
    if not service:
        return None
    return 1e3 * statistics.median(service)
