"""GPU generation registry: the data-sheet figures the device code reads.

The counterpart of `TpuGeneration`/`generation_for_device` in
`kubeoperator_tpu/parallel/topology.py`, cut to the fields the
diagnostics use: the memory rate and peak rates that bound a reading
(`koctl tpu diag`'s honesty guards, `chip_smoke.py`'s kernel bounds) and
the card's NVLink bandwidth (the envelope of collective bus bandwidth
between cards).

Figures are NVIDIA's published data-sheet values ("NVIDIA H100 Tensor
Core GPU" data sheet: the H100 SXM, H100 NVL and H100 PCIe columns),
dense rates without sparsity, at each part's full power limit. A card set
below its maximum power runs slower under load; readers compare against
these figures with the card's power limit beside them.

`SliceTopology` is a resolved pod slice cut to the fields the multislice
env contract (`parallel/multislice.py`) and `mesh_for_topology` read. The
reference derives them from its TPU registry (`parse_accelerator_type`);
the port takes them as given and keeps no TPU registry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SliceTopology:
    """A (multi)slice as the host env contract sees it: one process per
    host, `hosts_per_slice` hosts in each of `num_slices` slices, and
    `chips` devices per slice laid out as `ici_mesh`."""

    accelerator_type: str           # e.g. "v5p-16"
    chips: int                      # devices per slice
    chips_per_host: int             # devices per host of a multi-host slice
    hosts_per_slice: int
    ici_mesh: tuple[int, ...]
    num_slices: int = 1

    @property
    def total_hosts(self) -> int:
        return self.hosts_per_slice * self.num_slices

    @property
    def device_count(self) -> int:
        """Devices across the whole (multi)slice."""
        return self.chips * self.num_slices

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


# the multislice smoke's shape: two v5p-16 slices, 8 chips as 2x2x2 on two
# 4-chip hosts each (the reference's parse_accelerator_type("v5p-16",
# num_slices=2))
V5P_16_X2 = SliceTopology(accelerator_type="v5p-16", chips=8,
                          chips_per_host=4, hosts_per_slice=2,
                          ici_mesh=(2, 2, 2), num_slices=2)


@dataclass(frozen=True)
class GpuGeneration:
    """Static data-sheet facts about one GPU part."""

    name: str
    hbm_gbps_per_chip: float       # device-memory bandwidth, GB/s
    bf16_tflops_per_chip: float    # dense bf16 tensor-core peak
    fp32_tflops_per_chip: float    # float32 peak outside the tensor cores
    nvlink_gbps_per_gpu: float     # one direction over all of a card's
                                   # NVLink 4 links (25 GB/s each)


GENERATIONS: dict[str, GpuGeneration] = {
    g.name: g
    for g in (
        # 18 NVLink 4 links, 900 GB/s in all both ways: 25 GB/s per link
        # per direction, 18 x 25 = 450 GB/s per direction for the card
        GpuGeneration(name="h100-sxm", hbm_gbps_per_chip=3350.0,
                      bf16_tflops_per_chip=989.0, fp32_tflops_per_chip=67.0,
                      nvlink_gbps_per_gpu=450.0),
        # the NVL and PCIe parts reach a peer over NVLink bridges: 600 GB/s
        # both ways in the data sheet's "NVLink bridge" row, 12 links x 25
        # = 300 GB/s per direction
        GpuGeneration(name="h100-nvl", hbm_gbps_per_chip=3900.0,
                      bf16_tflops_per_chip=835.0, fp32_tflops_per_chip=60.0,
                      nvlink_gbps_per_gpu=300.0),
        GpuGeneration(name="h100-pcie", hbm_gbps_per_chip=2000.0,
                      bf16_tflops_per_chip=756.0, fp32_tflops_per_chip=51.0,
                      nvlink_gbps_per_gpu=300.0),
    )
}


def generation_for_name(name: str) -> GpuGeneration | None:
    """Map a CUDA device name ("NVIDIA H100 80GB HBM3", "NVIDIA H100
    PCIe", "NVIDIA H100 NVL") to its registry entry; None if unknown."""
    kind = name.lower()
    if "h100" not in kind:
        return None
    if "nvl" in kind:
        return GENERATIONS["h100-nvl"]
    if "pcie" in kind:
        return GENERATIONS["h100-pcie"]
    if "hbm3" in kind or "sxm" in kind:
        return GENERATIONS["h100-sxm"]
    return None


def generation_for_device(device: torch.device) -> GpuGeneration | None:
    """Registry entry of a `torch.device`; None for CPU or unknown parts,
    which callers refuse as `bench.py` and `koctl tpu diag` do."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return generation_for_name(torch.cuda.get_device_name(device))
