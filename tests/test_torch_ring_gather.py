"""Kernel K2's host side against the JAX package: the plain version of the
explicit ring all-gather bit-exact against the interpreted Pallas kernel,
the piece planner, a threaded twin of the kernel's counter protocol in
both forms, the drivers' contracts, and the process-per-rank form at 2 and
4 gloo ranks."""

import dataclasses
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.ops import collectives as jax_coll
from kubeoperator_tpu.ops import pallas_kernels as jax_pk
from kubeoperator_tpu.parallel.mesh import build_mesh
from kubeoperator_tpu_torch.ops import ring_gather as port
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env

from tests.test_torch_ops import spawn_ranks

COLS = port.COLS
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _global_input(n: int, rows_per_rank: int = 8) -> np.ndarray:
    return np.random.default_rng(n).standard_normal(
        (rows_per_rank * n, COLS)).astype(np.float32)


def _jax_ring(x: np.ndarray, n: int, jdtype) -> np.ndarray:
    """The interpreted Pallas ring on an n-device CPU mesh, as float32."""
    mesh = build_mesh(("devices",), (n,), jax.devices()[:n])
    out = jax_pk.ring_all_gather(jnp.asarray(x).astype(jdtype), mesh)
    return np.asarray(jnp.asarray(out).astype(jnp.float32))


# ------------------------------------------------- one card, virtual ranks ----
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_version_matches_the_jax_kernel(n, dtype):
    tdtype, jdtype = DTYPES[dtype]
    x = _global_input(n)
    want = _jax_ring(x, n, jdtype)
    got = port.ring_all_gather(torch.from_numpy(x).to(tdtype), ranks=n)
    assert got.shape == (n, 8 * n, COLS) and got.dtype == tdtype
    # bit-exact: a gather moves bytes, and bf16 rounding of the same f32
    # input is the same in both (round to nearest even)
    for r in range(n):
        np.testing.assert_array_equal(got[r].float().numpy(), want,
                                      err_msg=f"rank {r}")


def test_rows_not_divisible_raise_in_both():
    with pytest.raises(ValueError):
        jax_pk.ring_all_gather(jnp.ones((9, COLS), jnp.float32))
    with pytest.raises(ValueError, match="not divisible by 8"):
        port.ring_all_gather(torch.ones((9, COLS)), ranks=8)


@pytest.mark.parametrize("x, ranks, match", [
    (torch.ones((8, 512)), 2, r"\[rows, 1024\]"),
    (torch.ones((COLS, 16)).t(), 2, "contiguous"),
    (torch.ones((72, COLS)), 9, "1 to 8 ranks"),
    (torch.ones((8, COLS)), 0, "1 to 8 ranks"),
    (torch.ones((8, COLS), device="meta"), 2, "unsupported device"),
])
def test_invalid_inputs_raise(x, ranks, match):
    with pytest.raises(ValueError, match=match):
        port.ring_all_gather(x, ranks=ranks)


def test_step_slots_are_the_reference_kernels():
    # pallas_kernels.py:176-196: send rem(i, 2), receive rem(i + 1, 2),
    # source rem(my_id - i - 1 + n, n)
    for n in (2, 3, 8):
        for r in range(n):
            for i in range(n - 1):
                assert port.step_slots(r, i, n) == (i % 2, (i + 1) % 2,
                                                    (r - i - 1 + n) % n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_verify_one_card_form(n):
    assert port.verify_ring_all_gather(ranks=n, device="cpu") is True


def test_bench_result_matches_the_reference_keys():
    initialize_from_env("cpu")
    mesh = build_mesh(("devices",), (2,), jax.devices()[:2])
    ref = jax_pk.bench_ring_all_gather(size_mb=0.25, mesh=mesh, iters=2)
    got = port.bench_ring_all_gather(size_mb=0.25, iters=2, ranks=2,
                                     device="cpu")
    assert [f.name for f in dataclasses.fields(got)] \
        == [f.name for f in dataclasses.fields(jax_coll.CollectiveResult)]
    assert got.op == ref.op == "pallas_ring_all_gather"
    assert got.n_devices == ref.n_devices == 2
    assert got.bytes_per_device == ref.bytes_per_device == 56 * COLS * 4
    assert got.busbw_gbps == pytest.approx(got.algbw_gbps * 1)
    four = port.bench_ring_all_gather(ranks=4, device="cpu")
    assert four.busbw_gbps == pytest.approx(four.algbw_gbps * 3)
    # the host caps a run at 0.5 MB, as the reference's interpret mode does
    assert four.bytes_per_device == 120 * COLS * 4


# ------------------------------------------------------ the piece planner ----
def _check_plan(chunk_vec, blocks, piece_vec):
    plan = port.piece_plan(chunk_vec, blocks, piece_vec)
    pieces = port.pieces_per_block(chunk_vec, blocks, piece_vec)
    assert len(plan) == blocks and all(len(p) == pieces for p in plan)
    covered = np.zeros(chunk_vec, np.int64)
    last_hi = 0
    for ranges in plan:
        for lo, hi in ranges:
            # contiguous, in order, each at most one piece long
            assert lo == last_hi and lo <= hi <= lo + piece_vec
            # a range starts and ends on 16-byte vector boundaries of a
            # chunk that itself starts on one
            assert (lo * port.VEC_BYTES) % 16 == 0 and (hi * port.VEC_BYTES) % 16 == 0
            covered[lo:hi] += 1
            last_hi = hi
    assert last_hi == chunk_vec
    np.testing.assert_array_equal(covered, 1)  # every vector exactly once
    return pieces


@pytest.mark.parametrize("what, chunk_vec, blocks, pieces", [
    # verify_ring_all_gather's chunk: 8 rows of f32, ~132 blocks a rank
    ("verify", 8 * COLS * 4 // 16, 132, 1),
    # bench_ring_all_gather's 16 MB shard at n = 8: the one-card kernel
    # holds 528 co-resident blocks on an H100 (4 a SM), 66 a rank
    ("bench", 3904 * COLS * 4 // 16, 66, 8),
    # a chunk that is not a whole number of pieces per block
    ("ragged", 1001 * COLS * 4 // 16, 66, 2),
    # a chunk smaller than one piece, and fewer vectors than blocks
    ("tiny", 100, 8, 1),
    ("fewer vectors than blocks", 5, 8, 1),
])
def test_piece_plan_covers_each_vector_once(what, chunk_vec, blocks, pieces):
    assert _check_plan(chunk_vec, blocks, port.PIECE_VEC) == pieces


@pytest.mark.parametrize("piece_vec", [1, 7, 512, 1024, 4096])
def test_piece_plan_at_other_piece_sizes(piece_vec):
    for chunk_vec, blocks in ((2048, 132), (999_424, 132), (256_256, 99)):
        _check_plan(chunk_vec, blocks, piece_vec)


# ------------------------------------------------ the counter protocol twin ----
def _threaded_ring(shards, form="card", blocks=2, piece_vec=4, seed=0,
                   launches=2, slow=None, slow_s=0.02, recv_wait=True,
                   ready_wait=True, guard=True, timeout=10.0):
    """The kernel's schedule with one thread per (rank, block): the piece
    plan, piece-major order, the per-(rank, block) monotonic receive and
    ready counters behind a Condition, the launch base advancing by
    pieces x n. `form` "card" pushes into the right neighbour's output;
    "process" into its 2-slot landing buffer, with the ready wait and the
    guard on the previous launch. Seeded random sleeps skew the ranks;
    `slow` is a rank that sleeps `slow_s` more before every step. Returns
    (the last launch's outputs, violations): a violation is a read of a
    piece that has not landed (a stale piece forwarded) or a push into a
    slot piece its reader still needs."""
    n, chunk_vec = len(shards), len(shards[0])
    plan = port.piece_plan(chunk_vec, blocks, piece_vec)
    pieces = len(plan[0])
    flags = port._Flags(err=None, blocks=blocks, memory=None)
    bases = [flags.next_launch(pieces * n) for _ in range(launches)]
    cond = threading.Condition()
    recv = [[0] * blocks for _ in range(n)]
    ready = [[0] * blocks for _ in range(n)]
    outs = [[np.full(n * chunk_vec, np.nan, np.float32) for _ in range(n)]
            for _ in range(launches)]
    slots = [np.full((2, chunk_vec), np.nan, np.float32) for _ in range(n)]
    landed = set()   # card: (launch, rank, chunk, block, piece) in out[rank]
    tag = {}         # process: (rank, slot, block, piece) -> (launch, step)
    needed = set()   # process: slot pieces pushed and not yet read
    violations, errors = [], []
    last = n - 1 if form == "process" else max(n - 2, 0)

    def wait(counter, target, what):
        if not cond.wait_for(lambda: counter() >= target, timeout):
            raise TimeoutError(f"{what} >= {target}")

    def run(r, b):
        rng = random.Random(seed * 1000 + r * 16 + b)
        right, left = (r + 1) % n, (r - 1) % n
        for e, base in enumerate(bases):
            out = outs[e]
            with cond:
                if form == "process" and guard:
                    wait(lambda: ready[r][b], base, f"rank {r} previous launch")
            for p, (lo, hi) in enumerate(plan[b]):
                ev0 = base + p * n
                for i in range(last + 1):
                    c, push = (r - i) % n, i <= n - 2
                    time.sleep(rng.uniform(0, 0.002) + (slow_s if r == slow else 0))
                    with cond:
                        if i == 0:
                            src = shards[r][lo:hi].copy()
                        else:
                            if recv_wait:
                                wait(lambda: recv[r][b], ev0 + i, f"rank {r} recv")
                            if form == "card":
                                if (e, r, c, b, p) not in landed:
                                    violations.append(("stale", e, r, i, p))
                                src = out[r][c * chunk_vec + lo:c * chunk_vec + hi].copy()
                            else:
                                slot = port.step_slots(r, i, n)[0]
                                if tag.get((r, slot, b, p)) != (e, i - 1):
                                    violations.append(("stale", e, r, i, p))
                                needed.discard((r, slot, b, p))
                                src = slots[r][slot, lo:hi].copy()
                        if form == "process" and push and i >= 2 and ready_wait:
                            wait(lambda: ready[r][b], ev0 + i, f"rank {r} ready")
                        if form == "process" or i == 0:
                            out[r][c * chunk_vec + lo:c * chunk_vec + hi] = src
                        if push:
                            if form == "card":
                                out[right][c * chunk_vec + lo:c * chunk_vec + hi] = src
                                landed.add((e, right, c, b, p))
                            else:
                                slot = port.step_slots(r, i, n)[1]
                                if (right, slot, b, p) in needed:
                                    violations.append(("overwrite", e, r, i, p))
                                slots[right][slot, lo:hi] = src
                                tag[(right, slot, b, p)] = (e, i)
                                needed.add((right, slot, b, p))
                            recv[right][b] = ev0 + i + 1
                        if form == "process" and i > 0:
                            ready[left][b] = ev0 + i + 1
                        cond.notify_all()

    def main(r, b):
        try:
            run(r, b)
        except Exception as exc:  # reported by the caller
            errors.append(exc)

    threads = [threading.Thread(target=main, args=(r, b))
               for r in range(n) for b in range(blocks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return outs[-1], violations


def _twin_is_exact_under_skew(n, seed, form):
    rng = np.random.default_rng(seed)
    # 10 vectors a chunk over 2 blocks of 4-vector pieces: 2 pieces a
    # block, the second short
    shards = [rng.standard_normal(10).astype(np.float32) for _ in range(n)]
    outs, violations = _threaded_ring(shards, form=form, seed=seed,
                                      slow=seed % n)
    assert violations == []
    want = np.concatenate(shards)
    for r in range(n):
        np.testing.assert_array_equal(outs[r], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_flag_protocol_twin_is_exact_under_skew(n, seed):
    # the process form: 2-slot landing buffers, receive and ready waits,
    # the guard on the previous launch
    _twin_is_exact_under_skew(n, seed, "process")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_counter_protocol_twin_one_card_is_exact_under_skew(n, seed):
    # the one-card form: pushes land in the neighbour's output; receive
    # waits only
    _twin_is_exact_under_skew(n, seed, "card")


def test_counter_protocol_twin_without_the_receive_wait_trips():
    # rank 1 is slow: its right neighbour, never held back, forwards the
    # piece rank 1 has yet to push (a stale piece) at step 1
    rng = np.random.default_rng(0)
    shards = [rng.standard_normal(10).astype(np.float32) for _ in range(4)]
    for form in ("card", "process"):
        outs, violations = _threaded_ring(shards, form=form, recv_wait=False,
                                          slow=1, slow_s=0.3, launches=1)
        assert ("stale", 0, 2, 1, 0) in violations, form
        want = np.concatenate(shards)
        assert not all(np.array_equal(o, want) for o in outs), form
        _, clean = _threaded_ring(shards, form=form, slow=1, slow_s=0.3,
                                  launches=1)
        assert clean == [], form


def test_counter_protocol_twin_without_the_ready_wait_trips():
    # the process form reuses its 2 slots: rank 2 is slow, so rank 1
    # (fed by ranks 3 and 0, never held back by rank 2) reaches step 2 and
    # pushes into rank 2's slot 1 before rank 2 has read step 0's piece there
    rng = np.random.default_rng(2)
    shards = [rng.standard_normal(10).astype(np.float32) for _ in range(4)]
    _, violations = _threaded_ring(shards, form="process", ready_wait=False,
                                   slow=2, slow_s=0.3, launches=1)
    assert ("overwrite", 0, 1, 2, 0) in violations
    _, clean = _threaded_ring(shards, form="process", slow=2, slow_s=0.3,
                              launches=1)
    assert clean == []


def test_counter_protocol_twin_without_the_launch_guard_trips():
    # one piece, two ranks: rank 0 finishes launch 0 as soon as rank 1 has
    # pushed, and its launch-1 push lands in rank 1's slot 1 before the slow
    # rank 1 has read launch 0's piece from it
    rng = np.random.default_rng(1)
    shards = [rng.standard_normal(4).astype(np.float32) for _ in range(2)]
    _, violations = _threaded_ring(shards, form="process", blocks=1,
                                   guard=False, slow=1, slow_s=0.3)
    assert ("overwrite", 1, 0, 0, 0) in violations
    _, clean = _threaded_ring(shards, form="process", blocks=1, slow=1,
                              slow_s=0.3)
    assert clean == []


# -------------------------------------------- one process per rank (gloo) ----
_RANK_SCRIPT = """
import json, os, numpy as np, torch, torch.distributed as dist
from kubeoperator_tpu_torch.ops import ring_gather as rg
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
initialize_from_env("cpu")
rank, n = dist.get_rank(), dist.get_world_size()
mesh = flat_axis_mesh()
x = np.random.default_rng(n).standard_normal((8 * n, 1024)).astype(np.float32)
out = {"rank": rank, "n": n, "verify": rg.verify_ring_all_gather(),
       "bench": rg.bench_ring_all_gather(iters=2).to_dict()}
for dtype in ("float32", "bfloat16"):
    g = rg.ring_all_gather(torch.from_numpy(x).to(getattr(torch, dtype)), mesh)
    out[dtype] = g.float().numpy().tobytes().hex()
dist.barrier()
print("RANK_RESULT " + json.dumps(out), flush=True)
os._exit(0)
"""


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def ring_ranks(request):
    return spawn_ranks(request.param, _RANK_SCRIPT)


def test_process_form_matches_the_jax_kernel(ring_ranks):
    n = len(ring_ranks)
    x = _global_input(n)
    for dtype, (_, jdtype) in DTYPES.items():
        want = _jax_ring(x, n, jdtype)
        for r in ring_ranks:
            got = np.frombuffer(bytes.fromhex(r[dtype]), np.float32)
            np.testing.assert_array_equal(got.reshape(want.shape), want,
                                          err_msg=f"{dtype} rank {r['rank']}")


def test_process_form_verify_and_bench(ring_ranks):
    n = len(ring_ranks)
    for r in ring_ranks:
        assert r["n"] == n and r["verify"] is True
        b = r["bench"]
        assert b["op"] == "pallas_ring_all_gather" and b["n_devices"] == n
        assert b["busbw_gbps"] == pytest.approx(b["algbw_gbps"] * (n - 1))
