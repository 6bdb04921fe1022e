"""Explicit neighbour ring all-gather (kernel K2).

Counterpart of `ring_all_gather`, `bench_ring_all_gather` and
`verify_ring_all_gather` in `kubeoperator_tpu/ops/pallas_kernels.py`. The
kernel is hand-written CUDA C++ for sm_90a in `csrc/ring_all_gather.cu`
(its header note gives the protocol and the design);
`ring_all_gather_reference` is its plain PyTorch version.

Two host forms drive the one kernel body:

  one card, n virtual ranks   `ring_all_gather(x, ranks=n)`: one launch
                              holds all n ranks, each with its own shard
                              and output on the card; a rank pushes each
                              piece straight into its right neighbour's
                              output. Returns every rank's output,
                              [n, rows, 1024].
  one process per card        `ring_all_gather(x, mesh)`: each process
                              launches its own rank and pushes into its
                              right neighbour's 2-slot landing buffer; the
                              peers' slots and counters come from
                              `torch.distributed._symmetric_memory`.
                              Returns this rank's output, [rows, 1024].

Both split each block's range of a chunk into pieces (`piece_plan`, which
the kernel computes the same way) and signal after every piece.

A CUDA tensor launches the kernel or raises; only a tensor on the host
takes the plain version (the one-card form) or the same slot order over
`isend`/`irecv` (the process form, on gloo). `ring_all_gather.launches`
counts kernel launches. A protocol fault does not hang: a wait that spins
past `TIMEOUT_S` writes an error word, and `raise_on_ring_error` (called by
`verify` and `bench` after their readbacks) raises on it.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.ops import _build
from kubeoperator_tpu_torch.ops.collectives import AXIS, CollectiveResult
from kubeoperator_tpu_torch.ops.timing import differential_time_per_iter
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh, mesh_device
from kubeoperator_tpu_torch.utils.device import resolve_device

COLS = 1024          # row width of the reference's layout
MAX_RANKS = 8        # ranks one launch's pointer table holds
VEC_BYTES = 16       # the kernel copies 16-byte vectors
PTRS_PER_RANK = 8    # RankTable in csrc/ring_all_gather.cu
FLAG_BYTES = 8       # one u64 counter per (rank, block)
PIECE_VEC = 2048     # 32 KB: a block signals after each piece this size
TIMEOUT_S = 10.0     # a wait longer than this is a protocol fault


def step_slots(rank: int, i: int, n: int) -> tuple[int, int, int]:
    """(send slot, receive slot, source rank) of step i at `rank` in the
    process form: the chunk held in slot i % 2 (the own shard, read from
    `local`, at step 0) goes right, the left neighbour's lands in slot
    (i + 1) % 2 and belongs at out[src * chunk]."""
    return i % 2, (i + 1) % 2, (rank - i - 1) % n


def pieces_per_block(chunk_vec: int, blocks: int,
                     piece_vec: int = PIECE_VEC) -> int:
    """Pieces of every block's range: enough that the widest range's pieces
    hold at most `piece_vec` vectors (at least one)."""
    widest = -(-chunk_vec // blocks)
    return max(1, -(-widest // piece_vec))


def piece_plan(chunk_vec: int, blocks: int,
               piece_vec: int = PIECE_VEC) -> list[list[tuple[int, int]]]:
    """Each block's pieces as vector ranges [lo, hi) of a chunk, computed
    as the kernel computes them: block b owns [chunk_vec * b // blocks,
    chunk_vec * (b + 1) // blocks), split evenly into `pieces_per_block`
    pieces (some empty when the range is shorter than that)."""
    pieces = pieces_per_block(chunk_vec, blocks, piece_vec)
    plan = []
    for b in range(blocks):
        lo = chunk_vec * b // blocks
        length = chunk_vec * (b + 1) // blocks - lo
        plan.append([(lo + length * p // pieces, lo + length * (p + 1) // pieces)
                     for p in range(pieces)])
    return plan


def ring_all_gather_reference(shards: torch.Tensor) -> torch.Tensor:
    """Plain version of the one-card form: every rank's output [n, n * chunk,
    COLS] from shards [n, chunk, COLS], by stepping the ring with the
    kernel's pushes: at step i rank r writes the chunk it holds, (r - i)
    mod n, into its right neighbour's output."""
    n, chunk = shards.shape[0], shards.shape[1]
    out = shards.new_empty((n, n, chunk) + tuple(shards.shape[2:]))
    ranks = torch.arange(n)
    out[ranks, ranks] = shards
    for i in range(n - 1):
        held = (ranks - i) % n
        out[(ranks + 1) % n, held] = out[ranks, held]
    return out.view((n, n * chunk) + tuple(shards.shape[2:]))


def _check(x: torch.Tensor, n: int) -> int:
    """Validate a global [rows, COLS] input for an n-rank ring; the chunk."""
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"the ring takes 1 to {MAX_RANKS} ranks, got {n}")
    if x.dim() != 2 or x.shape[1] != COLS:
        raise ValueError(f"x must be [rows, {COLS}], got {tuple(x.shape)}")
    rows = x.shape[0]
    if rows == 0 or rows % n:
        raise ValueError(f"rows {rows} not divisible by {n} devices")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    chunk = rows // n
    if x.device.type == "cuda":
        if x.data_ptr() % VEC_BYTES:
            raise ValueError("x must be 16-byte aligned (the kernel copies 16 B)")
        if chunk * COLS * x.element_size() % VEC_BYTES:
            raise ValueError("a chunk must be a whole number of 16-byte vectors")
    return chunk


# ------------------------------------------------------------- the kernel ----
@functools.cache
def _lib():
    lib = _build.load("ring_all_gather")
    lib.ko_ring_all_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.ko_ring_all_gather.restype = ctypes.c_int
    lib.ko_ring_max_coresident_blocks.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ko_ring_max_coresident_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def _max_coresident_blocks(device_index: int, cross_card: bool) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().ko_ring_max_coresident_blocks(
            device_index, int(cross_card), ctypes.byref(out))
    if err:
        raise RuntimeError(f"ring_all_gather occupancy query: CUDA error {err}")
    return out.value


def _blocks_per_rank(device: torch.device, ranks_in_launch: int,
                     chunk_vec: int, cross_card: bool) -> int:
    """B: the co-resident grid split evenly over the launch's ranks, and no
    more blocks than a chunk has vectors."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    share = _max_coresident_blocks(index, cross_card) // ranks_in_launch
    return max(1, min(share, chunk_vec))


@dataclass(eq=False)
class _Flags:
    """Counters, error word and counter base of one set of ranks. The
    counters only grow, so a set is reused across launches as it is.

    One card: `memory` is int64 [n, B], the receive counters. One process
    per card: `memory` is this rank's symmetric buffer
    [slot0 | slot1 | recv[B] | ready[B]], `peers` every rank's address of
    it and `handle` the rendezvous that maps them."""
    err: torch.Tensor           # int64 [1], 0 while the protocol is healthy
    blocks: int
    memory: torch.Tensor
    peers: list[int] | None = None
    handle: object = None
    base: int = 0

    def next_launch(self, events: int) -> int:
        """The next launch's counter base; the launch signals `events`
        (pieces x n) counter values per block above it."""
        base, self.base = self.base, self.base + events
        return base


# Flag sets by (form, ..., B), kept for the life of the process: the
# counters must outlive a launch, and a peer set's rendezvous is collective.
_workspaces: dict[tuple, _Flags] = {}


def raise_on_ring_error() -> None:
    """Read every ring's error word (a device readback) and raise on a set
    one; a faulted flag set is dropped so the next call starts afresh."""
    for key, ws in list(_workspaces.items()):
        code = int(ws.err.item())
        if code:
            del _workspaces[key]
            # (piece + 1) << 32 | (rank + 1) << 16 | (step + 1) << 8 | kind,
            # as the kernel writes it
            piece, rank = (code >> 32) - 1, ((code >> 16) & 0xFFFF) - 1
            step, kind = ((code >> 8) & 0xFF) - 1, code & 0xFF
            what = {1: "its ready counter (the right neighbour reading a slot)",
                    2: "its receive counter (the left neighbour's push)",
                    3: "the right neighbour finishing the previous launch",
                    }.get(kind, f"kind {kind}")
            raise RuntimeError(
                f"ring_all_gather: rank {rank} waited more than {TIMEOUT_S:g} s "
                f"on {what} at step {step}, piece {piece} "
                f"(error word {code:#x})")


def _launch(ptrs: list[int], nlocal: int, n: int, first_rank: int,
            chunk_vec: int, ws: _Flags, device: torch.device,
            cross_card: bool) -> None:
    pieces = pieces_per_block(chunk_vec, ws.blocks, PIECE_VEC)
    base = ws.next_launch(pieces * n)
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(device):
        err = _lib().ko_ring_all_gather(
            table, nlocal, n, first_rank, ws.blocks, chunk_vec, pieces, base,
            int(cross_card), int(TIMEOUT_S * 1e9), ws.err.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"ring_all_gather kernel launch failed: CUDA error {err}")
    ring_all_gather.launches += 1


def _one_card_kernel(shards: torch.Tensor) -> torch.Tensor:
    """All n ranks in one launch on shards' card: [n, chunk, COLS] ->
    [n, n * chunk, COLS]."""
    n, chunk = shards.shape[0], shards.shape[1]
    dev = shards.device
    chunk_vec = chunk * COLS * shards.element_size() // VEC_BYTES
    blocks = _blocks_per_rank(dev, n, chunk_vec, cross_card=False)
    key = ("card", dev, n, blocks)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = _Flags(
            err=torch.zeros(1, dtype=torch.int64, device=dev), blocks=blocks,
            memory=torch.zeros((n, blocks), dtype=torch.int64, device=dev))
    recv = ws.memory
    out = shards.new_empty((n, n * chunk, COLS))
    ptrs = []
    for r in range(n):
        right = (r + 1) % n
        # a rank reads what it forwards from its own output and lands its
        # pushes in its right neighbour's; no ready counters
        ptrs += [shards[r].data_ptr(), out[r].data_ptr(), out[r].data_ptr(),
                 out[right].data_ptr(), recv[r].data_ptr(),
                 recv[right].data_ptr(), 0, 0]
    _launch(ptrs, n, n, 0, chunk_vec, ws, dev, cross_card=False)
    return out


def _peer_flags(group, dev: torch.device, chunk_bytes: int) -> _Flags:
    """This rank's symmetric buffer [slot0 | slot1 | recv[B] | ready[B]],
    mapped on every rank of `group`, with its peers' addresses."""
    import torch.distributed._symmetric_memory as symm_mem

    key = ("peer", group.group_name, dev, chunk_bytes)
    ws = _workspaces.get(key)
    if ws is not None:
        return ws
    # every rank must agree on B: the flags are per (rank, block)
    blocks = torch.tensor(
        [_blocks_per_rank(dev, 1, chunk_bytes // VEC_BYTES, cross_card=True)],
        dtype=torch.int64, device=dev)
    dist.all_reduce(blocks, op=dist.ReduceOp.MIN, group=group)
    blocks = int(blocks.item())
    if not symm_mem.is_symm_mem_enabled_for_group(group.group_name):
        with warnings.catch_warnings():  # deprecated and implicit in newer torch
            warnings.simplefilter("ignore", FutureWarning)
            symm_mem.enable_symm_mem_for_group(group.group_name)
    nbytes = 2 * chunk_bytes + 2 * blocks * FLAG_BYTES
    buf = symm_mem.empty(nbytes, dtype=torch.uint8, device=dev)
    buf.zero_()
    handle = symm_mem.rendezvous(buf, group)
    torch.cuda.synchronize(dev)
    dist.barrier(group=group)  # every rank's flags are zero before any signal
    ws = _workspaces[key] = _Flags(
        err=torch.zeros(1, dtype=torch.int64, device=dev), blocks=blocks,
        memory=buf, peers=list(handle.buffer_ptrs), handle=handle)
    return ws


def _process_kernel(local: torch.Tensor, group) -> torch.Tensor:
    """This process's rank of the ring over `group`: [chunk, COLS] ->
    [n * chunk, COLS]."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    chunk = local.shape[0]
    chunk_bytes = chunk * COLS * local.element_size()
    ws = _peer_flags(group, local.device, chunk_bytes)
    peers = ws.peers
    right, left = (rank + 1) % n, (rank - 1) % n
    flags = 2 * chunk_bytes
    ready = flags + ws.blocks * FLAG_BYTES
    out = local.new_empty((n * chunk, COLS))
    ptrs = [local.data_ptr(), out.data_ptr(), peers[rank], peers[right],
            peers[rank] + flags, peers[right] + flags,
            peers[rank] + ready, peers[left] + ready]
    _launch(ptrs, 1, n, rank, chunk_bytes // VEC_BYTES, ws, local.device,
            cross_card=True)
    return out


def _process_p2p(local: torch.Tensor, group) -> torch.Tensor:
    """The process form on host tensors: the kernel's pushes and slots over
    isend/irecv, one step at a time."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    chunk = local.shape[0]
    out = local.new_empty((n * chunk, COLS))
    slots = local.new_empty((2, chunk, COLS))
    out[rank * chunk:(rank + 1) * chunk] = local
    right = dist.get_global_rank(group, (rank + 1) % n)
    left = dist.get_global_rank(group, (rank - 1) % n)
    for i in range(n - 1):
        send, recv, src = step_slots(rank, i, n)
        held = local if i == 0 else slots[send]
        for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, held, right, group=group),
            dist.P2POp(dist.irecv, slots[recv], left, group=group),
        ]):
            work.wait()
        out[src * chunk:(src + 1) * chunk] = slots[recv]
    return out


def _gather_virtual(shards: torch.Tensor) -> torch.Tensor:
    if shards.device.type == "cpu":
        return ring_all_gather_reference(shards)
    return _one_card_kernel(shards)


def _gather_process(local: torch.Tensor, group) -> torch.Tensor:
    if local.device.type == "cpu":
        return _process_p2p(local, group)
    if dist.get_world_size(group) == 1:
        return _one_card_kernel(local.unsqueeze(0))[0]
    return _process_kernel(local, group)


def ring_all_gather(x: torch.Tensor, mesh: DeviceMesh | None = None, *,
                    ranks: int | None = None) -> torch.Tensor:
    """All-gather a row-sharded [n * chunk, COLS] array through the explicit
    ring. With `ranks=n`, the one-card form on x's device: returns every
    virtual rank's output, [n, rows, COLS]. Otherwise each process of
    `mesh` (default: all ranks) takes its row shard of x and gets the
    gathered array, [rows, COLS]."""
    if ranks is not None:
        chunk = _check(x, ranks)
        return _gather_virtual(x.view(ranks, chunk, COLS))
    mesh = mesh or flat_axis_mesh(AXIS)
    group = mesh.get_group(0)
    n = dist.get_world_size(group)
    chunk = _check(x, n)
    rank = dist.get_rank(group)
    return _gather_process(x[rank * chunk:(rank + 1) * chunk], group)


ring_all_gather.launches = 0


# ---------------------------------------------------------- the drivers ----
def _resolve(mesh, ranks, device):
    """(n, device, mesh, group) of a driver call; mesh and group are None
    in the one-card form."""
    if ranks is not None:
        return ranks, resolve_device(device), None, None
    mesh = mesh or flat_axis_mesh(AXIS)
    group = mesh.get_group(0)
    return dist.get_world_size(group), mesh_device(mesh), mesh, group


def bench_ring_all_gather(
    size_mb: float = 16.0, mesh: DeviceMesh | None = None, iters: int = 10,
    *, ranks: int | None = None, device: torch.device | str | None = None,
) -> CollectiveResult:
    """Bus bandwidth of the explicit ring (nccl-tests all_gather convention:
    busbw = (n-1) * shard_bytes / t). Each iteration gathers, then keeps
    this rank's shard x (1/n), so iterations chain at shard size. With
    `ranks=n` on one card the figure is HBM-to-HBM copying, not a link."""
    n, dev, _, group = _resolve(mesh, ranks, device)
    if dev.type != "cuda":
        size_mb = min(size_mb, 0.5)  # host runs are for tests
        iters = min(iters, 2)
    chunk = max(int(size_mb * 1e6) // (COLS * 4) // 8, 1) * 8
    if group is None:
        x = torch.ones((n, chunk, COLS), dtype=torch.float32, device=dev)
        diag = torch.arange(n, device=dev)

        def step(v):
            g = _gather_virtual(v).view(n, n, chunk, COLS)
            return g[diag, diag].mul_(1.0 / n)
    else:
        rank = dist.get_rank(group)
        x = torch.ones((chunk, COLS), dtype=torch.float32, device=dev)

        def step(v):
            g = _gather_process(v, group)
            return g[rank * chunk:(rank + 1) * chunk].mul(1.0 / n)

    def run(k: int) -> float:
        v = x
        for _ in range(k):
            v = step(v)
        total = float(v.sum().item())  # scalar readback: waits for every launch
        if dev.type == "cuda":
            raise_on_ring_error()
        return total

    dt = differential_time_per_iter(
        run, lo=max(iters // 4, 1), hi=max(iters, iters // 4 + 2))
    shard_bytes = chunk * COLS * 4
    algbw = shard_bytes / dt / 1e9
    return CollectiveResult(
        op="pallas_ring_all_gather", n_devices=n,
        bytes_per_device=shard_bytes, time_per_iter_s=dt,
        algbw_gbps=algbw, busbw_gbps=algbw * (n - 1),
    )


def verify_ring_all_gather(
    mesh: DeviceMesh | None = None, *, ranks: int | None = None,
    device: torch.device | str | None = None,
) -> bool:
    """Correctness gate: every rank's output of the explicit ring equals the
    input bit for bit (an arange, so any misplaced chunk shows). The
    verdict is agreed over the group."""
    n, dev, mesh, group = _resolve(mesh, ranks, device)
    rows = 8 * n
    x = torch.arange(rows * COLS, dtype=torch.float32, device=dev).view(rows, COLS)
    out = ring_all_gather(x, mesh, ranks=ranks)
    # the process form returns this rank's output, the one-card form all n
    ok = torch.equal(out, x if group is not None else x.expand(n, rows, COLS))
    if dev.type == "cuda":
        raise_on_ring_error()
    if group is not None:  # min-reduced, so every rank returns the same
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        ok = bool(flag.item())
    return ok
