"""The port's serving against the JAX package's, on the host: request
digests on the same params and seeds at world 1 in both modes and at 4
gloo ranks (one module-scoped spawn) on meshes (data, fsdp, tp) = (2,2,1)
and (1,2,2), the record's keys, the ``("stop", why)`` drain, and a
``("reshard", MeshSpec)`` from 4 ranks (data=4) to 2 (data=2): the
survivors keep answering on the smaller global batch, the other two stop
and say so.

Tolerance: digests (sum(y²)/size of the global f32 output) within 1e-5
relative — the same f32 arithmetic in other summation orders; they agree
to about 1e-6.
"""

import json

import jax
import numpy as np
import pytest

from kubeoperator_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.workloads import serve as jsv
from kubeoperator_tpu.workloads import step as js
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.workloads import partition as ppart
from kubeoperator_tpu_torch.workloads import serve as psv

from tests.test_torch_ops import spawn_ranks

DIGEST_RTOL = 1e-5
PARAMS_SEED, SEED, REQUESTS = 4, 7, 4
MESHES = [("data=2,fsdp=2,tp=1", "pjit"), ("data=1,fsdp=2,tp=2", "pjit"),
          ("data=1,fsdp=2,tp=2", "shard_map")]
RESHARD_AFTER = 2


def _params():
    """The reference's seeded host params, and the same as the port's."""
    ref = js.build_host_params(seed=PARAMS_SEED)
    return ref, ppart.tree_map(ppart.as_tensor, ref)


def _jax_serve(spec, mode, on_request=None):
    ref, _ = _params()
    return jsv.run_serving(JaxMeshSpec.parse(spec).build(), params=ref,
                           requests=REQUESTS, mode=mode, seed=SEED,
                           on_request=on_request)


def _reshard_jax(served, _latency):
    if served == RESHARD_AFTER:
        return ("reshard", JaxMeshSpec.parse("data=2,fsdp=1,tp=1"))
    return None


def _assert_record_like(got, ref):
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose(got["outputs"], ref["outputs"], rtol=DIGEST_RTOL)
    for key in ("ok", "finite", "served", "requests", "mode", "devices", "mesh",
                "degraded", "drained", "drain_reason", "end_step", "slo_ms",
                "slo_met"):
        assert got[key] == ref[key], key
    assert [(w["name"], w["attrs"]) for w in got["windows"]] \
        == [(w["name"], w["attrs"]) for w in ref["windows"]]


@pytest.mark.parametrize("mode", ["pjit", "shard_map", "auto"])
def test_digests_match_jax_at_world_one(mode):
    initialize_from_env("cpu")
    spec = "data=1,fsdp=1,tp=1"
    _, params = _params()
    got = psv.run_serving(MeshSpec.parse(spec).build("cpu"), params=params,
                          requests=REQUESTS, mode=mode, seed=SEED)
    _assert_record_like(got, _jax_serve(spec, mode))
    assert got["mode"] == ("pjit" if mode == "auto" else mode)


def test_fresh_params_from_the_seed_match_jax():
    initialize_from_env("cpu")
    spec = "data=1,fsdp=1,tp=1"
    got = psv.run_serving(MeshSpec.parse(spec).build("cpu"), requests=2, seed=3)
    ref = jsv.run_serving(JaxMeshSpec.parse(spec).build(), requests=2, seed=3)
    np.testing.assert_allclose(got["outputs"], ref["outputs"], rtol=DIGEST_RTOL)


def test_stop_drains_like_the_reference():
    initialize_from_env("cpu")
    spec = "data=1,fsdp=1,tp=1"
    _, params = _params()

    def stop(served, _latency):
        return ("stop", "preemption notice") if served == 2 else None

    got = psv.run_serving(MeshSpec.parse(spec).build("cpu"), params=params,
                          requests=REQUESTS, seed=SEED, on_request=stop)
    ref = _jax_serve(spec, "auto", stop)
    _assert_record_like(got, ref)
    assert got["served"] == got["end_step"] == 2
    assert got["drained"] and got["drain_reason"] == "preemption notice"


def test_serve_errors_match_reference():
    initialize_from_env("cpu")
    mesh, jmesh = MeshSpec.parse("data=1,fsdp=1,tp=1").build("cpu"), \
        JaxMeshSpec.parse("data=1,fsdp=1,tp=1").build()
    cases = [
        (lambda: psv.compile_forward(mesh, specs=None, mode="pjit"),
         lambda: jsv.compile_forward(jmesh, specs=None, mode="pjit")),
        (lambda: psv.make_forward(mesh, mode="gspmd"),
         lambda: jsv.make_forward(jmesh, mode="gspmd")),
        (lambda: psv.compile_forward(MeshSpec.parse("dp=1").build("cpu")),
         lambda: jsv.compile_forward(JaxMeshSpec.parse("dp=8").build())),
    ]
    for port, ref in cases:
        with pytest.raises(ppart.PartitionError) as got:
            port()
        with pytest.raises(Exception) as want:
            ref()
        assert type(want.value).__name__ == "PartitionError"
        assert str(got.value) == str(want.value)
    assert [(p, tuple(s)) for p, s in psv.serve_rules()] \
        == [(p, tuple(s)) for p, s in jsv.serve_rules()]


# ------------------------------------------------------- 4 gloo ranks ----
_RANK_SCRIPT = """
import json, os
import torch.distributed as dist
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.workloads import serve, step
initialize_from_env("cpu")
rank = dist.get_rank()
params = step.build_host_params(seed={params_seed})
res = {{"rank": rank}}
for spec, mode in {meshes}:
    rec = serve.run_serving(MeshSpec.parse(spec).build(), params=params,
                            requests={requests}, mode=mode, seed={seed})
    res[f"{{spec}}/{{mode}}"] = rec
def reshard(served, _latency):
    if served == {after}:
        return ("reshard", MeshSpec.parse("data=2,fsdp=1,tp=1"))
res["reshard"] = serve.run_serving(MeshSpec.parse("data=4,fsdp=1,tp=1").build(),
                                   params=params, requests={requests}, seed={seed},
                                   on_request=reshard)
dist.barrier()
print("RANK_RESULT " + json.dumps(res), flush=True)
os._exit(0)
"""


@pytest.fixture(scope="module")
def four_ranks():
    return spawn_ranks(4, _RANK_SCRIPT.format(
        params_seed=PARAMS_SEED, meshes=MESHES, requests=REQUESTS, seed=SEED,
        after=RESHARD_AFTER))


@pytest.mark.parametrize("spec, mode", MESHES)
def test_digests_match_jax_on_four_ranks(four_ranks, spec, mode):
    ref = _jax_serve(spec, mode)
    for r in four_ranks:      # every rank answers with the global digest
        _assert_record_like(r[f"{spec}/{mode}"], ref)


def test_reshard_from_four_ranks_to_two(four_ranks):
    ref = _jax_serve("data=4,fsdp=1,tp=1", "auto", _reshard_jax)
    assert ref["degraded"] and ref["served"] == REQUESTS and ref["devices"] == 2
    survivors, others = four_ranks[:2], four_ranks[2:]
    for r in survivors:
        _assert_record_like(r["reshard"], ref)
    for r in others:
        rec = r["reshard"]
        assert sorted(rec) == sorted(ref)
        assert rec["served"] == RESHARD_AFTER and rec["degraded"]
        assert rec["drained"] and "without this rank" in rec["drain_reason"]
        assert rec["mesh"] == {"data": 4, "fsdp": 1, "tp": 1}
        np.testing.assert_allclose(rec["outputs"], ref["outputs"][:RESHARD_AFTER],
                                   rtol=DIGEST_RTOL)
    # the global batch shrank with the mesh: the digests after the reshard
    # are over the first half of the rows
    assert json.dumps(survivors[0]["reshard"]["mesh"]) == '{"data": 2, "fsdp": 1, "tp": 1}'


def test_digest_is_over_the_global_output(four_ranks):
    # every rank of a mesh reports the same digest
    for spec, mode in MESHES:
        outs = {tuple(r[f"{spec}/{mode}"]["outputs"]) for r in four_ranks}
        assert len(outs) == 1, spec
    assert jax.device_count() >= 4
