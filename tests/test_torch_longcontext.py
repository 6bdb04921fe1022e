"""The port's ring and Ulysses attention against the JAX package's, on the
same numpy arrays: full reference attention, both at world size 1 in
process, and both at 2 and 4 gloo ranks (one process each, one spawn per
size) against the JAX functions on a mesh of the same size and against
reference attention on the whole arrays. Their gradients at 2 and 4 ranks
are held against autograd through reference attention on the gathered
arrays; Ulysses' refusal of heads that do not divide is the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeoperator_tpu.ops import longcontext_check as jax_check
from kubeoperator_tpu.parallel import longcontext as jax_lc
from kubeoperator_tpu.parallel.mesh import build_mesh
from kubeoperator_tpu_torch.ops import longcontext_check as port_check
from kubeoperator_tpu_torch.parallel import longcontext as port_lc
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env

from tests.test_torch_cuda import _bf16_grads_hold_to_float64
from tests.test_torch_ops import spawn_ranks

# f32 on both sides, same products in another summation order: a few ulp
# of the O(1) outputs; the reference's own gate is 2e-4
F32_TOL = 2e-5
RING_TOL = 2e-4


def _arrays(n: int, s_local: int = 8, seed: int = 0, b=2, h=4, dh=16):
    rng = np.random.default_rng(seed)
    shape = (b, s_local * n, h, dh)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_sharded(fn, arrays, n: int, causal: bool, dtype=jnp.float32):
    mesh = build_mesh(("sp",), (n,), jax.devices()[:n])
    spec = NamedSharding(mesh, P(None, "sp", None, None))
    q, k, v = (jax.device_put(jnp.asarray(a).astype(dtype), spec)
               for a in arrays)
    out = fn(q, k, v, mesh, axis_name="sp", causal=causal)
    return np.asarray(jnp.asarray(out).astype(jnp.float32))


def _jax_ring(arrays, n: int, causal: bool, dtype=jnp.float32) -> np.ndarray:
    return _jax_sharded(jax_lc.ring_attention, arrays, n, causal, dtype)


def _jax_ulysses(arrays, n: int, causal: bool) -> np.ndarray:
    return _jax_sharded(jax_lc.ulysses_attention, arrays, n, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    arrays = _arrays(2)
    want = np.asarray(jax_lc.reference_attention(
        *(jnp.asarray(a) for a in arrays), causal=causal))
    got = port_lc.reference_attention(
        *(torch.from_numpy(a) for a in arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_at_world_one_matches_jax(causal):
    initialize_from_env("cpu")
    mesh = flat_axis_mesh("sp", device_type="cpu")
    arrays = _arrays(1)
    got = port_lc.ring_attention(*(torch.from_numpy(a) for a in arrays),
                                 mesh, causal=causal)
    np.testing.assert_allclose(got.numpy(), _jax_ring(arrays, 1, causal),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_at_world_one_matches_jax(causal):
    initialize_from_env("cpu")
    mesh = flat_axis_mesh("sp", device_type="cpu")
    arrays = _arrays(1)
    got = port_lc.ulysses_attention(*(torch.from_numpy(a) for a in arrays),
                                    mesh, causal=causal)
    np.testing.assert_allclose(got.numpy(), _jax_ulysses(arrays, 1, causal),
                               rtol=F32_TOL, atol=F32_TOL)


def test_bf16_ring_at_world_one_matches_jax():
    # bf16 operands, f32 accumulation on both sides; the output rounds to
    # bf16 (relative step 2^-8), so 1e-2 holds while a wrong block would not
    initialize_from_env("cpu")
    mesh = flat_axis_mesh("sp", device_type="cpu")
    arrays = _arrays(1, s_local=64, seed=3)
    got = port_lc.ring_attention(
        *(torch.from_numpy(a).bfloat16() for a in arrays), mesh, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_ring(arrays, 1, True, jnp.bfloat16),
                               rtol=1e-2, atol=1e-2)


def test_bf16_products_keep_f32_accumulation():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
    got = port_lc._bmm_f32(a.bfloat16(), b.bfloat16())
    assert got.dtype == torch.float32
    # bf16 x bf16 products are exact in f32: only the summation order can
    # differ from a float64 sum of the same products
    want = torch.matmul(a.bfloat16().double(), b.bfloat16().double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_verify_and_bench_at_world_one():
    initialize_from_env("cpu")
    mesh = flat_axis_mesh("sp", device_type="cpu")
    assert port_check.verify_ring_attention(mesh) is True
    assert port_check.verify_ring_attention(mesh, causal=False) is True
    r = port_check.bench_ring_attention(seq_per_device=32, iters=2, mesh=mesh)
    assert [f.name for f in dataclasses.fields(r)] \
        == [f.name for f in dataclasses.fields(jax_check.RingAttentionResult)]
    d = r.to_dict()
    assert d["seq_global"] == 32 and d["causal"] is True and d["tflops"] >= 0


def test_verify_fails_on_a_wrong_mask(monkeypatch):
    # the gate has teeth: a ring that drops its causal mask fails it
    initialize_from_env("cpu")
    mesh = flat_axis_mesh("sp", device_type="cpu")
    real = port_check.ring_attention

    def unmasked(q, k, v, mesh, axis_name="sp", causal=False):
        return real(q, k, v, mesh, axis_name=axis_name, causal=False)

    monkeypatch.setattr(port_check, "ring_attention", unmasked)
    assert port_check.verify_ring_attention(mesh, causal=True) is False
    assert port_check.verify_ring_attention(mesh, causal=False) is True


# -------------------------------------------- 2 and 4 gloo ranks ----
_RANK_SCRIPT = """
import json, os, numpy as np, torch, torch.distributed as dist
from kubeoperator_tpu_torch.ops import longcontext_check as lc
from kubeoperator_tpu_torch.parallel.longcontext import ring_attention
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
initialize_from_env("cpu")
rank, n = dist.get_rank(), dist.get_world_size()
mesh = flat_axis_mesh("sp")
rng = np.random.default_rng(0)
arrays = [rng.standard_normal((2, 8 * n, 4, 16)).astype(np.float32)
          for _ in range(3)]
q, k, v = (torch.from_numpy(np.ascontiguousarray(a[:, rank * 8:(rank + 1) * 8]))
           for a in arrays)
out = {"rank": rank, "n": n, "verify": lc.verify_ring_attention(mesh),
       "verify_noncausal": lc.verify_ring_attention(mesh, causal=False),
       # the bench's own 8 iterations: a differential over one iteration
       # falls inside a loaded host's scheduling noise and can come out
       # negative (clamped to 1 ns, which to_dict rounds to 0.0)
       "bench": lc.bench_ring_attention(seq_per_device=16, mesh=mesh).to_dict()}
for causal in (False, True):
    out[f"causal={causal}"] = ring_attention(q, k, v, mesh, causal=causal).tolist()
# the gradient of sum(w * ring(q, k, v)), with the rotation's backward and
# then with it dropped (no gradient crosses ranks)
from kubeoperator_tpu_torch.parallel import comm
w = torch.from_numpy(np.ascontiguousarray(
    rng.standard_normal((2, 8 * n, 4, 16)).astype(np.float32)[:, rank * 8:(rank + 1) * 8]))
def grads():
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ring_attention(*leaves, mesh, causal=True) * w).sum().backward()
    return [t.grad.tolist() for t in leaves]
out["grads"] = grads()
real = comm._PPermute.backward
comm._PPermute.backward = staticmethod(lambda ctx, g: (None, None))
out["grads_dropped"] = grads()
comm._PPermute.backward = real
# Ulysses over the same ranks: outputs, the gradient through its
# all-to-alls, and its refusal of 3 heads
from kubeoperator_tpu_torch.parallel.longcontext import ulysses_attention
for causal in (False, True):
    out[f"ulysses causal={causal}"] = ulysses_attention(
        q, k, v, mesh, causal=causal).tolist()
leaves = [t.clone().requires_grad_() for t in (q, k, v)]
(ulysses_attention(*leaves, mesh, causal=True) * w).sum().backward()
out["ulysses_grads"] = [t.grad.tolist() for t in leaves]
try:
    ulysses_attention(*(t[:, :, :3] for t in (q, k, v)), mesh)
except ValueError as e:
    out["ulysses_refusal"] = str(e)
dist.barrier()
print("RANK_RESULT " + json.dumps(out), flush=True)
os._exit(0)
"""


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def attention_ranks(request):
    return spawn_ranks(request.param, _RANK_SCRIPT)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_across_ranks_matches_jax(attention_ranks, causal):
    n = len(attention_ranks)
    want = _jax_ring(_arrays(n), n, causal)
    got = np.concatenate([np.asarray(r[f"causal={causal}"], np.float32)
                          for r in attention_ranks], axis=1)
    np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL)


def test_verify_and_bench_across_ranks(attention_ranks):
    n = len(attention_ranks)
    for r in attention_ranks:
        assert r["n"] == n
        assert r["verify"] is True and r["verify_noncausal"] is True
        b = r["bench"]
        assert b["n_devices"] == n and b["seq_global"] == 16 * n
        assert b["tflops"] >= 0 and b["time_per_iter_s"] > 0


def _reference_grads(n: int) -> list[np.ndarray]:
    """d/d(q, k, v) of sum(w * attention) on the full arrays (autograd
    through reference_attention), with the ranks' w."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((2, 8 * n, 4, 16)).astype(np.float32)
              for _ in range(3)]
    w = torch.from_numpy(rng.standard_normal((2, 8 * n, 4, 16)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (port_lc.reference_attention(*leaves, causal=True) * w).sum().backward()
    return [t.grad.numpy() for t in leaves]


def _gathered_grads(ranks, key: str) -> list[np.ndarray]:
    return [np.concatenate([np.asarray(r[key][i], np.float32) for r in ranks],
                           axis=1) for i in range(3)]


def test_ring_gradient_matches_reference_attention(attention_ranks):
    n = len(attention_ranks)
    for got, want, name in zip(_gathered_grads(attention_ranks, "grads"),
                               _reference_grads(n), "qkv"):
        np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL,
                                   err_msg=name)


def test_ring_gradient_needs_the_rotation_backward(attention_ranks):
    # the same check fails when the rotation's backward is dropped: k and
    # v miss every later rank's contribution
    n = len(attention_ranks)
    got = _gathered_grads(attention_ranks, "grads_dropped")
    want = _reference_grads(n)
    np.testing.assert_allclose(got[0], want[0], rtol=RING_TOL, atol=RING_TOL)
    for i in (1, 2):
        assert not np.allclose(got[i], want[i], rtol=RING_TOL, atol=RING_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_across_ranks_matches_jax_and_full_attention(attention_ranks,
                                                             causal):
    n = len(attention_ranks)
    arrays = _arrays(n)
    got = np.concatenate([np.asarray(r[f"ulysses causal={causal}"], np.float32)
                          for r in attention_ranks], axis=1)
    full = port_lc.reference_attention(*(torch.from_numpy(a) for a in arrays),
                                       causal=causal).numpy()
    np.testing.assert_allclose(got, full, rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(got, _jax_ulysses(arrays, n, causal),
                               rtol=RING_TOL, atol=RING_TOL)


def test_ulysses_gradient_matches_reference_attention(attention_ranks):
    n = len(attention_ranks)
    for got, want, name in zip(_gathered_grads(attention_ranks, "ulysses_grads"),
                               _reference_grads(n), "qkv"):
        np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL,
                                   err_msg=name)


def test_ulysses_refuses_heads_that_do_not_divide(attention_ranks):
    n = len(attention_ranks)
    mesh = build_mesh(("sp",), (n,), jax.devices()[:n])
    bad = jax.device_put(jnp.zeros((2, 8 * n, 3, 16), jnp.float32),
                         NamedSharding(mesh, P(None, "sp", None, None)))
    with pytest.raises(ValueError) as want:
        jax_lc.ulysses_attention(bad, bad, bad, mesh)
    assert "not divisible" in str(want.value)
    assert [r["ulysses_refusal"] for r in attention_ranks] == [str(want.value)] * n


def test_bmm_f32_function_backward(monkeypatch):
    # the card's product (aten::bmm.dtype) has no host kernel; with the
    # host's widening product in its place, _BmmF32's backward takes the
    # f32 cotangent at full precision, like autograd through that product
    monkeypatch.setattr(port_lc, "_bmm_dtype",
                        lambda a, b: torch.matmul(a.float(), b.float()))
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for s in ((2, 4, 64, 32), (2, 4, 32, 48)))
    w = torch.from_numpy(rng.standard_normal((2, 4, 64, 48)).astype(np.float32))
    a1, b1 = (t.clone().requires_grad_() for t in (a, b))
    out = port_lc._BmmF32.apply(a1, b1)
    assert torch.equal(out, torch.matmul(a.float(), b.float()))
    _bf16_grads_hold_to_float64(*torch.autograd.grad((out * w).sum(), (a1, b1)),
                                a, b, w)

