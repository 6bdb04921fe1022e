"""Port of ops/ (matmul, triad, collectives) against the JAX package on the
host: result keys, the triad chain's values, the bus factors, and the
collectives at world size 1 (in process) and 2 (gloo ranks in separate
processes, bootstrapped through the KO_TPU_* env contract), with the Ready
gate and `tpu diag` run for real at 2 ranks. `spawn_ranks` is the one
spawn helper of the port's multi-rank tests; `one_spawn_at_a_time` is the
lock it holds, which tests that spawn ranks through the port's own entry
points hold too."""

import contextlib
import dataclasses
import fcntl
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeoperator_tpu.ops import collectives as jax_coll
from kubeoperator_tpu.ops import hbm as jax_hbm
from kubeoperator_tpu.ops import matmul as jax_matmul
from kubeoperator_tpu.parallel.mesh import build_mesh, shard_map_compat
from kubeoperator_tpu_torch.ops import collectives as port_coll
from kubeoperator_tpu_torch.ops import hbm as port_hbm
from kubeoperator_tpu_torch.ops import matmul as port_matmul
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import HostEnv, initialize_from_env
from kubeoperator_tpu_torch.utils.launch import free_port_pair, run_ranks

OPS = ("psum", "all_gather", "reduce_scatter", "all_to_all", "ppermute")
SHARD = 16   # elements per rank in the chain parity check
STEPS = 3    # chained iterations


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def test_matmul_result_keys_match_reference():
    got = port_matmul.mxu_matmul_tflops(size=64, iters=1, device="cpu").to_dict()
    want = jax_matmul.mxu_matmul_tflops(size=64, iters=1).to_dict()
    assert list(got) == list(want)
    assert got["dtype"] == want["dtype"] == "bfloat16"
    assert got["tflops"] > 0


def test_matmul_folded_scale_equals_scaling_after():
    # size a power of two: (v @ (w * 2^-k)) rounded once == round(v @ w) * 2^-k
    rng = np.random.default_rng(0)
    size = 64
    v = torch.from_numpy(rng.standard_normal((size, size), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((size, size), np.float32))
    folded = torch.matmul(v, w.mul(1.0 / size).bfloat16())
    after = torch.matmul(v, w.bfloat16()).mul_(1.0 / size)
    assert torch.equal(folded, after)


def test_triad_result_keys_match_reference():
    got = port_hbm.hbm_bandwidth_gbps(size_mb=1.0, iters=1, device="cpu")
    assert _fields(port_hbm.HbmResult) == _fields(jax_hbm.HbmResult)
    assert got.bytes_streamed == 3 * (1_000_000 // 4096) * 1024 * 4
    assert got.gbps > 0


def _jax_triad(a, b, n):
    # the reference's chain body (kubeoperator_tpu/ops/hbm.py)
    return np.asarray(jax.lax.fori_loop(
        0, n, lambda _, v: (v + 2.5 * b) * 0.5, jnp.asarray(a)))


@pytest.mark.parametrize("n", [1, 4, 9])
def test_triad_chain_matches_reference(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((16, 1024)).astype(np.float32)
    b = rng.standard_normal((16, 1024)).astype(np.float32)
    got = port_hbm.triad_chain(torch.from_numpy(a), torch.from_numpy(b), n)
    want = _jax_triad(a, jnp.asarray(b), n)
    # lerp rounds twice per step where the reference rounds once; the chain
    # halves old error each step, so a few ulp of f32 bound it
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # ones: every step value is dyadic, exact in both
    ones = np.ones((8, 1024), np.float32)
    got1 = port_hbm.triad_chain(torch.from_numpy(ones), torch.from_numpy(ones), n)
    np.testing.assert_array_equal(got1.numpy(), _jax_triad(ones, jnp.asarray(ones), n))


@pytest.mark.parametrize("op", OPS)
def test_bus_factor_table_matches_reference(op):
    for n in (1, 2, 4, 8, 16):
        assert port_coll._bus_factor(op, n) == jax_coll._bus_factor(op, n)


def test_collective_result_keys_and_world_one():
    initialize_from_env("cpu")
    mesh = flat_axis_mesh(device_type="cpu")
    assert _fields(port_coll.CollectiveResult) == _fields(jax_coll.CollectiveResult)
    r = port_coll.bench_collective("psum", size_mb=0.01, mesh=mesh, iters=2)
    assert r.n_devices == 1 and r.bytes_per_device == 2500 * 4
    assert r.busbw_gbps == r.algbw_gbps
    assert port_coll.verify_psum_correctness(mesh) is True


# ------------------------------------------------------- two gloo ranks ----
_RANK_SCRIPT = """
import json, os, torch, torch.distributed as dist
from kubeoperator_tpu_torch.ops import collectives as c, psum_smoke
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import HostEnv, initialize_from_env
from kubeoperator_tpu_torch.utils.launch import free_port_pair, run_ranks
initialize_from_env("cpu")
rank, n = dist.get_rank(), dist.get_world_size()
mesh = flat_axis_mesh()
x = torch.arange(n * {shard}, dtype=torch.float32)[rank * {shard}:(rank + 1) * {shard}]
out = {{"rank": rank, "n": n, "psum_ok": c.verify_psum_correctness(mesh),
        "chains": {{op: c.run_chain(op, x, {steps}, mesh).tolist() for op in {ops}}},
        "bench": c.bench_collective("all_gather", size_mb=0.01, mesh=mesh,
                                    iters=2).to_dict()}}
out["smoke"] = psum_smoke.run_smoke(sizes_mb=(0.01,), iters=2, device="cpu")
# the multi-device diag branch for real, its collective suite cut to size
import contextlib, functools, io
from kubeoperator_tpu_torch import ops
from kubeoperator_tpu_torch.cli import koctl
ops.run_collective_suite = functools.partial(ops.run_collective_suite,
                                             sizes_mb=(0.01,), iters=2)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    out["diag_rc"] = koctl.main(["tpu", "diag", "--cpu", "--size", "64",
                                 "--iters", "2"])
out["diag"] = json.loads(buf.getvalue())
dist.barrier()
print("RANK_RESULT " + json.dumps(out), flush=True)
# skip teardown: gloo can abort a rank whose peer (or the store's host)
# tears down first, which says nothing about the code under test
os._exit(0)
"""


@contextlib.contextmanager
def one_spawn_at_a_time():
    """Hold a host-wide file lock for the life of one multi-rank spawn, so
    that the suite's parallel workers start one set of rank processes at a
    time. Ranks started side by side oversubscribe the host's cores, and
    timing-sensitive tests elsewhere in the suite (the phase-DAG budget in
    tests/test_static_gate.py) lose their margin under that load."""
    path = os.path.join(tempfile.gettempdir(), "kubeoperator_tpu_torch-ranks.lock")
    with open(path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def spawn_ranks(n: int, script: str, timeout: float = 180) -> list[dict]:
    """The RANK_RESULT dicts that `script` prints in n gloo ranks (n <= 4),
    one process each, joined through the host env contract
    (`HostEnv.to_env`, started by `utils/launch.py::run_ranks`); sorted by
    rank. One spawn runs at a time (`one_spawn_at_a_time`)."""
    assert n <= 4, "tier-1 gloo tests stay at 4 ranks or fewer"
    with one_spawn_at_a_time():
        port = free_port_pair()
        # one compute thread a rank: n ranks of tiny shapes need no more,
        # and the suite's other workers share the host's cores
        envs = [dict(HostEnv(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=n, process_id=rank).to_env(),
                     OMP_NUM_THREADS="1", KO_TPU_TRAIN_STEPS=None)
                for rank in range(n)]
        ran = run_ranks(script, envs, timeout)
    results = []
    for rc, out, err in ran:
        assert rc == 0, err[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RANK_RESULT ")]
        results.append(json.loads(line[0].split(" ", 1)[1]))
    return sorted(results, key=lambda r: r["rank"])


@pytest.fixture(scope="module")
def gloo_ranks():
    """Results of _RANK_SCRIPT from 2 gloo ranks."""
    return spawn_ranks(2, _RANK_SCRIPT.format(shard=SHARD, steps=STEPS, ops=OPS))


def test_psum_correctness_at_two_ranks(gloo_ranks):
    assert [r["n"] for r in gloo_ranks] == [2, 2]
    assert all(r["psum_ok"] is True for r in gloo_ranks)


def _jax_chains(n):
    """Every op's chained output on an n-device JAX CPU mesh, built from the
    same lax bodies as kubeoperator_tpu/ops/collectives.py::_collective_fn."""
    mesh = build_mesh(("devices",), (n,), jax.devices()[:n])
    x = jax.device_put(jnp.arange(n * SHARD, dtype=jnp.float32),
                       NamedSharding(mesh, P("devices")))
    bodies = {
        "psum": lambda v: jax.lax.psum(v, "devices") / n,
        "all_gather": lambda v: jax.lax.dynamic_slice_in_dim(
            jax.lax.all_gather(v, "devices", tiled=True),
            jax.lax.axis_index("devices") * v.shape[0], v.shape[0]),
        "reduce_scatter": lambda v: jnp.tile(
            jax.lax.psum_scatter(v, "devices", tiled=True) / n, n),
        "all_to_all": lambda v: jax.lax.all_to_all(
            v.reshape(n, -1), "devices", 0, 0, tiled=False).reshape(v.shape),
        "ppermute": lambda v: jax.lax.ppermute(
            v, "devices", [(i, (i + 1) % n) for i in range(n)]),
    }
    chains = {}
    for op, body in bodies.items():
        fn = shard_map_compat(
            lambda v, body=body: jax.lax.fori_loop(0, STEPS, lambda _, u: body(u), v),
            mesh=mesh, in_specs=P("devices"), out_specs=P("devices"))
        chains[op] = np.asarray(jax.jit(fn)(x))
        # the package's own chained runner agrees on the global sum
        assert float(jax_coll._collective_fn(op, mesh)(x, STEPS)) == chains[op].sum()
    return chains


def test_chained_collectives_match_jax_mesh_bit_exact(gloo_ranks):
    want = _jax_chains(2)
    for op in OPS:
        got = np.concatenate([np.asarray(r["chains"][op], np.float32)
                              for r in gloo_ranks])
        np.testing.assert_array_equal(got, want[op], err_msg=op)


def test_two_rank_bench_and_gate_refusal(gloo_ranks):
    # the gate used to refuse at 2 ranks; it now runs the ring-attention
    # check and passes
    for r in gloo_ranks:
        b = r["bench"]
        assert b["n_devices"] == 2
        assert b["busbw_gbps"] == pytest.approx(b["algbw_gbps"] * 1.0)
        smoke = r["smoke"]
        assert smoke["ok"] is True and smoke["chips"] == 2
        assert smoke["correctness"] is True
        assert smoke["ring_attention_correct"] is True


@pytest.fixture(scope="module")
def jax_smoke_line() -> str:
    """The JAX gate's KO_TPU_SMOKE_RESULT line on the 8-device CPU mesh."""
    from kubeoperator_tpu.adm.phases import SMOKE_MARKER
    from kubeoperator_tpu.ops import psum_smoke as jax_smoke

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KO_TPU_EXPECTED_CHIPS", raising=False)
        mp.delenv("KO_TPU_TRAIN_STEPS", raising=False)
        result = jax_smoke.run_smoke(sizes_mb=(0.01,), iters=2)
    return SMOKE_MARKER + " " + json.dumps(result)


@pytest.mark.parametrize("ctx_kw, verdict", [
    ({}, "pass"),                                   # no plan: no chip count
    ({"smoke_test_gbps_threshold": 1e9}, "fail: threshold"),
    ({"tpu": True}, "fail: chip count"),            # v5e-16 plan wants 16
])
def test_two_rank_gate_line_gives_the_jax_verdict(gloo_ranks, jax_smoke_line,
                                                  ctx_kw, verdict):
    from kubeoperator_tpu.adm.phases import SMOKE_MARKER, parse_marker_json

    from tests.test_torch_smoke import _verdict

    port = SMOKE_MARKER + " " + json.dumps(gloo_ranks[0]["smoke"])
    ref = jax_smoke_line
    assert list(parse_marker_json(SMOKE_MARKER, [port])) \
        == list(parse_marker_json(SMOKE_MARKER, [ref]))
    assert _verdict(port, **ctx_kw) == _verdict(ref, **ctx_kw) == verdict


def test_two_rank_diag_report_has_the_jax_key_set(gloo_ranks, monkeypatch,
                                                   capsys):
    from tests.test_torch_diag import MULTI_DEVICE_KEYS, _jax_report

    ref = _jax_report(monkeypatch, capsys)
    assert MULTI_DEVICE_KEYS <= set(ref)
    for r in gloo_ranks:
        diag = r["diag"]
        assert r["diag_rc"] == 0 and diag["devices"] == 2
        assert set(diag) - {"not_a_known_gpu"} == set(ref) - {"not_a_tpu"}
        assert diag["ring_all_gather_correct"] is True
        assert diag["ring_attention_correct"] is True
        assert diag["pallas_ring"]["op"] == "pallas_ring_all_gather"
        assert list(diag["ring_attention"]) == [
            "n_devices", "seq_global", "heads", "head_dim", "causal",
            "time_per_iter_s", "tflops"]
        assert diag["ring_attention"]["seq_global"] == 512
