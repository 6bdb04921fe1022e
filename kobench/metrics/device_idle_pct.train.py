"""device_idle_pct.train: the share of the window in which no kernel, copy
or fill runs on any stream of a card (busy time is the union of their
intervals), averaged over the cards."""


def read(layer: dict):
    trace = layer.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["ranks"] / layer["window_s"])
