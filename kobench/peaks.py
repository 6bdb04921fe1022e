"""Published dense peaks of the cards the benchmark knows (NVIDIA data
sheets, without sparsity), looked up by `torch.cuda.get_device_name()`.
The first entry whose key is in the name wins, so the specific parts come
before the plain "H100" (the SXM part)."""

from __future__ import annotations

BF16_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
)


def bf16_flops(device_name: str) -> float | None:
    """The card's bf16 tensor-core peak in FLOP/s; None for a card not in
    the table (a share of an unknown peak is not reported)."""
    for key, peak in BF16_FLOPS:
        if key in device_name:
            return peak
    return None
