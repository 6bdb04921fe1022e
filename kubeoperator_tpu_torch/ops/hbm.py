"""Device-memory stream bandwidth via a one-pass triad.

Counterpart of `kubeoperator_tpu/ops/hbm.py::hbm_bandwidth_gbps`, whose
triad `(v + 2.5*b) * 0.5` XLA fuses into one pass that streams three
buffers (read v, read b, write o). Written eagerly in PyTorch the same
expression makes two or three passes (five or more streams), and a byte
count of three streams would then overstate the rate. So the step here is
`torch.lerp(v, 2.5*b, 0.5)`: the same value, 0.5*v + 1.25*b, in one
elementwise pass that reads two buffers and writes one, and
`bytes_streamed` counts exactly those three streams. `2.5*b` is formed
once per chain, outside the steps. The rounding differs from the
reference's by about an ulp per step (lerp subtracts, then halves).

Buffers are 256 MB by default: more than five times the H100's 50 MB L2,
so the reading is a device-memory number and not a cache number.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubeoperator_tpu_torch.ops.timing import differential_time_per_iter
from kubeoperator_tpu_torch.utils.device import resolve_device

COLS = 1024


@dataclass(frozen=True)
class HbmResult:
    bytes_streamed: int
    time_s: float
    gbps: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def triad_chain(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """`n` chained steps v <- (v + 2.5*b) * 0.5 from v = a; `a` and `b`
    are left as they are (the steps ping-pong between two buffers)."""
    b25 = b * 2.5
    bufs = (torch.empty_like(a), torch.empty_like(a))
    v = a
    for i in range(n):
        v = torch.lerp(v, b25, 0.5, out=bufs[i % 2])
    return v


def hbm_bandwidth_gbps(
    size_mb: float = 256.0, iters: int = 10,
    device: torch.device | str | None = None,
) -> HbmResult:
    """Sustained triad bandwidth; on the host a tiny run (tests only)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        size_mb = min(size_mb, 8.0)
        iters = min(iters, 4)
    elem = 4
    rows = max(int(size_mb * 1e6) // (COLS * elem), 8)
    x = torch.ones((rows, COLS), dtype=torch.float32, device=dev)
    y = torch.ones((rows, COLS), dtype=torch.float32, device=dev)

    def run(n: int) -> float:
        return float(triad_chain(x, y, n).sum().item())  # scalar readback

    dt = differential_time_per_iter(
        run, lo=max(iters // 8, 1), hi=max(iters, iters // 8 + 2)
    )
    bytes_streamed = 3 * rows * COLS * elem  # read v, read 2.5*b, write o
    return HbmResult(
        bytes_streamed=bytes_streamed, time_s=dt,
        gbps=bytes_streamed / dt / 1e9,
    )
