"""expert_load_max_over_mean: the routed slots of the busiest held expert
over the held experts' mean, in the MoE layer where that is largest, from
the expert layer's device counter summed over the window's steps."""


def read(layer: dict):
    loads = layer.get("expert_loads")
    worst = None
    for counts in loads or ():
        mean = sum(counts) / len(counts)
        if mean > 0:
            ratio = max(counts) / mean
            worst = ratio if worst is None else max(worst, ratio)
    return worst
