"""mla_attention_roofline: K3's latent-width kernels' share of the card's
bf16 peak: the operations they must execute a step (`kobench/flops_mla.py`)
times the window's steps, over their device time in the traced window
(every `attention_kernel` and `delta_kernel` launch) and the peak of
`kobench/peaks.py`."""


def read(layer: dict):
    peak = layer.get("peak_flops")
    busy = layer.get("k3_s")
    if not peak or not busy or not layer.get("steps"):
        return None
    return 100.0 * layer["k3_operations"] * layer["steps"] / (busy * peak)
