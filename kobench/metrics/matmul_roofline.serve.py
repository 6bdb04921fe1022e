"""matmul_roofline.serve: the FLOPs the profiler gives aten's mm, addmm, bmm and baddbmm
calls, over the device time of the kernels those calls launched and the
card's bf16 peak. Numerator and denominator cover the same kernels; a
float32 product reads low against the bf16 peak."""


def read(layer: dict):
    trace = layer.get("trace")
    peak = layer.get("peak_flops")
    if not trace or not peak or not trace["matmul_s"] or not trace["matmul_flops"]:
        return None
    return 100.0 * trace["matmul_flops"] / (trace["matmul_s"] * peak)
