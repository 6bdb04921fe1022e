"""Kernel K2's host side against the JAX package: the plain version of the
explicit ring all-gather bit-exact against the interpreted Pallas kernel,
a threaded twin of the kernel's flag protocol, the drivers' contracts, and
the process-per-rank form at 2 and 4 gloo ranks."""

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


# ----------------------------------------------- the flag protocol twin ----
def _threaded_ring(shards, ready_wait=True, seed=0, launches=2, slow=None,
                   slow_s=0.02, timeout=10.0):
    """The kernel's protocol with one thread per rank: its slot indices, its
    monotonic receive/ready counters behind a Condition, its step-0 wait on
    the previous launch. Seeded random sleeps skew the ranks; `slow` is a
    rank that sleeps `slow_s` more before every push. Returns (outputs,
    violations): a violation is a write into a slot whose reader still
    needs it."""
    n, chunk = len(shards), shards[0].shape[0]
    cond = threading.Condition()
    comm = [[None, None] for _ in range(n)]
    needed = [[False, False] for _ in range(n)]
    recv = [0] * n
    ready = [0] * n
    outs = [np.zeros((n * chunk, COLS), np.float32) for _ in range(n)]
    violations, errors = [], []

    def wait(counter, r, target, what):
        if not cond.wait_for(lambda: counter[r] >= target, timeout):
            raise TimeoutError(f"rank {r} {what} >= {target}")

    def rank_main(r):
        rng = random.Random(seed * 1000 + r)
        right, left = (r + 1) % n, (r - 1) % n

        def nap():
            time.sleep(rng.uniform(0, 0.002) + (slow_s if r == slow else 0))

        try:
            for epoch in range(1, launches + 1):
                base = epoch * n
                with cond:
                    if needed[r][0]:
                        violations.append((epoch, r, -1))
                    outs[r][r * chunk:(r + 1) * chunk] = shards[r]
                    comm[r][0] = shards[r].copy()
                    needed[r][0] = True
                for i in range(n - 1):
                    send, recv_slot, src = port.step_slots(r, i, n)
                    nap()
                    with cond:
                        if i > 0 and ready_wait:
                            wait(ready, r, base + i, "ready")
                        elif i == 0 and epoch > 1:
                            wait(ready, r, base - 1, "ready")
                        if needed[right][recv_slot]:
                            violations.append((epoch, r, i))
                        comm[right][recv_slot] = comm[r][send].copy()
                        needed[right][recv_slot] = True
                        needed[r][send] = False  # the push was its last use
                        recv[right] = base + i + 1
                        cond.notify_all()
                    nap()
                    with cond:
                        wait(recv, r, base + i + 1, "recv")
                        outs[r][src * chunk:(src + 1) * chunk] = comm[r][recv_slot]
                        if i == n - 2:
                            needed[r][recv_slot] = False  # copied out: done
                        ready[left] = base + i + 1
                        cond.notify_all()
        except Exception as e:  # reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return outs, violations


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_flag_protocol_twin_is_exact_under_skew(n, seed):
    rng = np.random.default_rng(seed)
    shards = [rng.standard_normal((4, COLS)).astype(np.float32)
              for _ in range(n)]
    outs, violations = _threaded_ring(shards, seed=seed, slow=seed % n)
    assert violations == []
    want = np.concatenate(shards)
    for r in range(n):
        np.testing.assert_array_equal(outs[r], want, err_msg=f"rank {r}")


def test_flag_protocol_twin_without_the_ready_wait_trips():
    # rank 1 is slow: its left neighbour, never held back, pushes step 1
    # into rank 1's slot 0 while rank 1 has yet to send its own shard
    rng = np.random.default_rng(0)
    shards = [rng.standard_normal((4, COLS)).astype(np.float32)
              for _ in range(4)]
    _, violations = _threaded_ring(shards, ready_wait=False, slow=1,
                                   slow_s=0.3, launches=1)
    assert (1, 0, 1) in violations
    _, clean = _threaded_ring(shards, ready_wait=True, slow=1, slow_s=0.3,
                              launches=1)
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
