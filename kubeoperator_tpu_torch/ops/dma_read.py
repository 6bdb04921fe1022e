"""Explicit-copy read stream over device memory (kernel K1).

Counterpart of `dma_read_bandwidth_gbps` and `_dma_read` in
`kubeoperator_tpu/ops/pallas_kernels.py`. The kernel is hand-written CUDA
C++ for sm_90a in `csrc/dma_read.cu` (its header note gives the design);
`dma_read_reference` is its plain PyTorch version.

`dma_read(x, seed)` launches the kernel for a CUDA tensor and takes the
plain version only for a tensor on the host. `dma_read.launches` counts
the kernel's launches, so a run can show that a path went through it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from kubeoperator_tpu_torch.ops import _build
from kubeoperator_tpu_torch.ops.timing import differential_time_per_iter
from kubeoperator_tpu_torch.utils.device import resolve_device

COLS = 1024        # row width of the reference's layout
CHUNK_ROWS = 256   # the reference's chunk: rows must be a multiple of it
TILE_ROWS = 8      # the kernel's tile, and the output's row count
BLOCKS_PER_SM = 1  # persistent grid: one block per SM
FINISHERS = 64     # blocks that sum the partials, one column slice each
TIMEOUT_S = 10.0   # a finisher waiting longer writes NaN instead of hanging


def dma_read_reference(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Plain version: seed + x.view(-1, 8, 1024).sum(0), f32 [8, 1024]."""
    return seed + x.view(-1, TILE_ROWS, COLS).sum(0)


def _check(x: torch.Tensor, seed: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != COLS:
        raise ValueError(
            f"x must be float32 [rows, {COLS}], got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] == 0 or x.shape[0] % CHUNK_ROWS:
        raise ValueError(
            f"rows must be a positive multiple of {CHUNK_ROWS}, got {x.shape[0]}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if seed.dtype != torch.float32 or tuple(seed.shape) != (1,):
        raise ValueError(
            f"seed must be float32 [1], got {seed.dtype} {tuple(seed.shape)}")
    if seed.device != x.device:
        raise ValueError(f"seed is on {seed.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel copies 16 B)")


def tile_plan(tiles: int, nblocks: int) -> list[range]:
    """Each block's 8-row tiles, in the order the kernel streams them: dealt
    round-robin, block b taking b, b + nblocks, ... (counts differ by at
    most one)."""
    if not 1 <= nblocks <= tiles:
        raise ValueError(f"need 1 <= nblocks <= tiles, got {nblocks}, {tiles}")
    return [range(b, tiles, nblocks) for b in range(nblocks)]


def finisher_count(nblocks: int) -> int:
    """Blocks that finish: the largest power of two <= min(nblocks,
    FINISHERS), so the 8192 outputs split into equal column slices."""
    cap = min(nblocks, FINISHERS)
    return 1 << (cap.bit_length() - 1)


@functools.cache
def _kernel():
    fn = _build.load("dma_read").ko_dma_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@dataclass(eq=False)
class _Scratch:
    """One stream's scratch, made once: the block partials and the ticket
    counters (u32 [2]), which the kernel leaves zero for its next launch.
    Launches on one stream run one after another, so they share it; two
    streams may run launches at once, so each has its own."""
    sms: int
    counters: torch.Tensor
    partials: dict[int, torch.Tensor]


_scratch: dict[tuple[torch.device, int], _Scratch] = {}


def _stream_scratch(device: torch.device, stream: torch.cuda.Stream) -> _Scratch:
    key = (device, stream.cuda_stream)
    sc = _scratch.get(key)
    if sc is None:
        sc = _scratch[key] = _Scratch(
            sms=torch.cuda.get_device_properties(device).multi_processor_count,
            counters=torch.zeros(2, dtype=torch.int32, device=device),
            partials={})
    return sc


def dma_read(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """seed + x.view(-1, 8, 1024).sum(0) for f32 x [rows, 1024], rows a
    multiple of 256, and f32 seed [1] on the same device."""
    _check(x, seed)
    if x.device.type == "cpu":
        return dma_read_reference(x, seed)
    fn = _kernel()
    tiles = x.shape[0] // TILE_ROWS
    stream = torch.cuda.current_stream(x.device)
    sc = _stream_scratch(x.device, stream)
    nblocks = min(tiles, sc.sms * BLOCKS_PER_SM)
    partials = sc.partials.get(nblocks)
    if partials is None:
        partials = sc.partials[nblocks] = torch.empty(
            (nblocks, TILE_ROWS, COLS), dtype=torch.float32, device=x.device)
    out = torch.empty((TILE_ROWS, COLS), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.shape[0], seed.data_ptr(),
                 partials.data_ptr(), nblocks, finisher_count(nblocks),
                 sc.counters.data_ptr(), out.data_ptr(),
                 int(TIMEOUT_S * 1e9), stream.cuda_stream)
    if err:
        raise RuntimeError(f"dma_read kernel launch failed: CUDA error {err}")
    dma_read.launches += 1
    return out


dma_read.launches = 0


@dataclass(frozen=True)
class DmaReadResult:
    bytes_read: int
    time_s: float
    gbps: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def dma_read_bandwidth_gbps(
    size_mb: float = 256.0, iters: int = 20,
    device: torch.device | str | None = None,
) -> DmaReadResult:
    """Sustained device-memory read bandwidth through the explicit
    bulk-copy stream kernel."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        size_mb = min(size_mb, 1.0)  # host runs are for tests
        iters = min(iters, 2)
    else:
        # keep the differential window long (~300 x 256 MB) so launch and
        # readback jitter cancel
        iters = max(iters, 300)
    rows = max(int(size_mb * 1e6) // (COLS * 4) // CHUNK_ROWS, 1) * CHUNK_ROWS
    x = torch.ones((rows, COLS), dtype=torch.float32, device=dev)
    lo, hi = max(iters // 8, 1), max(iters, iters // 8 + 2)
    # one seed per iteration, made once on the device: the timed loop does
    # no host-to-device copy and no sync until its final readback
    seeds = torch.arange(hi, dtype=torch.float32, device=dev).split(1)

    def run(n: int) -> float:
        out = None
        for i in range(n):
            out = dma_read(x, seeds[i])
        return float(out[0, 0].item())

    dt = differential_time_per_iter(run, lo=lo, hi=hi)
    bytes_read = rows * COLS * 4
    return DmaReadResult(
        bytes_read=bytes_read, time_s=dt, gbps=bytes_read / dt / 1e9
    )
