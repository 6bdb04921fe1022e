"""The port's multislice env contract, `mesh_for_topology` and DCN smoke
against the JAX package's: `host_envs`, `survivor_host_envs` and
`degraded_mesh_spec` on one table of inputs fed through the reference's
`parse_accelerator_type` (the same blocks and the same `TopologyError`
messages), the mesh axes of a table of topologies, and
`run_dcn_smoke()` (4 gloo processes) against the reference's
`run_dcn_smoke(local_devices=1)` (4 JAX processes)."""

import dataclasses

import jax
import pytest

from kubeoperator_tpu.ops import dcn_smoke as jax_dcn
from kubeoperator_tpu.parallel import mesh as jax_mesh
from kubeoperator_tpu.parallel import multislice as jax_ms
from kubeoperator_tpu.parallel.topology import (
    GENERATIONS,
    SliceTopology as JaxSliceTopology,
    parse_accelerator_type,
)
from kubeoperator_tpu_torch.ops import dcn_smoke as port_dcn
from kubeoperator_tpu_torch.parallel import mesh as port_mesh
from kubeoperator_tpu_torch.parallel import multislice as port_ms
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.topology import V5P_16_X2, SliceTopology

from tests.test_torch_ops import one_spawn_at_a_time


def twin(topo: JaxSliceTopology) -> SliceTopology:
    """The port's slice topology of a reference one."""
    return SliceTopology(
        accelerator_type=topo.accelerator_type, chips=topo.chips,
        chips_per_host=topo.generation.chips_per_host,
        hosts_per_slice=topo.hosts_per_slice, ici_mesh=tuple(topo.ici_mesh),
        num_slices=topo.num_slices)


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:   # noqa: BLE001 - compared across packages
        return ("error", type(e).__name__, str(e))
    return ("ok", out)


# (accelerator type, slices, coordinator host, port)
ENV_TABLE = [
    ("v5e-1", 1, "10.0.0.2", 8476),
    ("v5e-8", 1, "10.0.0.2", 8476),
    ("v5e-16", 1, "10.0.0.2", 65535),
    ("v5e-16", 2, "10.0.0.2", 9000),
    ("v5p-16", 2, "127.0.0.1", 8476),
    ("v4-32", 3, "coord", 1),
    ("v6e-64", 2, "h", 40000),
    ("v5e-16", 2, "10.0.0.2", 65535),    # port+1 overflows
    ("v5e-16", 1, "", 8476),             # no coordinator
    ("v5e-16", 2, "   ", 8476),
    ("v5p-8", 1, "10.0.0.2", 0),         # port out of range
    ("v5p-8", 2, "10.0.0.2", 70000),
]


def _table_id(row):
    return "-".join(str(v) or "empty" for v in row)


def _env_dicts(envs):
    return [(dataclasses.asdict(e), e.to_env()) for e in envs]


@pytest.mark.parametrize("row", ENV_TABLE, ids=_table_id)
def test_host_envs_match_the_reference(row):
    acc, slices, host, port = row
    topo = parse_accelerator_type(acc, num_slices=slices)
    want = _outcome(lambda: _env_dicts(jax_ms.host_envs(topo, host, port)))
    got = _outcome(lambda: _env_dicts(port_ms.host_envs(twin(topo), host, port)))
    assert got == want


def test_zero_host_topology_is_refused_like_the_reference():
    # an unvalidated construction that resolves to 0 hosts (v5p 2 chips)
    broken = JaxSliceTopology(generation=GENERATIONS["v5p"], chips=2,
                              ici_mesh=(1, 1, 2))
    want = _outcome(lambda: jax_ms.host_envs(broken, "10.0.0.2"))
    got = _outcome(lambda: port_ms.host_envs(twin(broken), "10.0.0.2"))
    assert got == want and "0 hosts" in got[2]


@pytest.mark.parametrize("lost", [(), (0,), (1,), (0, 2), (2,), (0, 1, 2),
                                  (3,), (-1,)], ids=str)
@pytest.mark.parametrize("row", [("v5e-16", 3, "10.0.0.2", 9000),
                                 ("v5p-16", 3, "h", 65535)], ids=_table_id)
def test_survivor_host_envs_match_the_reference(row, lost):
    acc, slices, host, port = row
    topo = parse_accelerator_type(acc, num_slices=slices)
    want = _outcome(lambda: _env_dicts(
        jax_ms.survivor_host_envs(topo, host, port, lost_slices=lost)))
    got = _outcome(lambda: _env_dicts(
        port_ms.survivor_host_envs(twin(topo), host, port, lost_slices=lost)))
    assert got == want


DEGRADE_TABLE = [
    ("data=4,fsdp=2,tp=1", 2, 1),
    ("data=4,fsdp=2,tp=1", 4, 1),
    ("data=1,fsdp=4,tp=2", 2, 1),
    ("data=3,fsdp=4,tp=1", 4, 2),
    ("data=1,fsdp=1,tp=8", 2, 1),      # tp alone: refused
    ("data=2,fsdp=1,tp=1", 1, 1),      # not a multislice
    ("data=2,fsdp=1,tp=1", 2, 2),      # nothing survives
    ("data=2,fsdp=1,tp=1", 2, 0),
    ("fsdp=6,tp=2", 3, 1),
]


@pytest.mark.parametrize("row", DEGRADE_TABLE, ids=_table_id)
def test_degraded_mesh_spec_matches_the_reference(row):
    spec, slices, lost = row

    def run(pkg, mesh_spec_cls):
        new, axis = pkg.degraded_mesh_spec(mesh_spec_cls.parse(spec), slices, lost)
        return new.axes, axis

    want = _outcome(lambda: run(jax_ms, jax_mesh.MeshSpec))
    got = _outcome(lambda: run(port_ms, port_mesh.MeshSpec))
    assert got == want


# (accelerator type, slices); the reference builds each mesh on the
# virtual devices, so at most 8 devices
MESH_TABLE = [("v5e-1", 1), ("v5e-4", 1), ("v5e-8", 1), ("v5p-8", 1),
              ("v4-8", 2), ("v5e-4", 2), ("v5e-1", 2), ("v6e-8", 1)]


@pytest.mark.parametrize("row", MESH_TABLE, ids=_table_id)
def test_topology_mesh_axes_match_the_reference(row):
    acc, slices = row
    topo = parse_accelerator_type(acc, num_slices=slices)
    mesh = jax_mesh.mesh_for_topology(
        topo, devices=jax.devices()[:topo.jax_device_count])
    names, shape = port_mesh.topology_axes(twin(topo))
    assert tuple(names) == mesh.axis_names
    assert tuple(shape) == mesh.devices.shape
    assert twin(topo).device_count == topo.jax_device_count


def test_mesh_for_topology_at_world_one_and_its_refusals():
    initialize_from_env("cpu")
    one = parse_accelerator_type("v5e-1")
    mesh = port_mesh.mesh_for_topology(twin(one), device_type="cpu")
    assert mesh.mesh_dim_names == ("ici_0", "ici_1") and tuple(mesh.shape) == (1, 1)
    named = port_mesh.mesh_for_topology(twin(one), ["x", "y"], device_type="cpu")
    assert named.mesh_dim_names == ("x", "y")
    devs = jax.devices()[:1]
    cases = [
        (parse_accelerator_type("v5e-4"), None),        # wrong device count
        (parse_accelerator_type("v5e-1", num_slices=2), None),
        (one, ["only"]),                                 # names vs axes
        (one, ["a", "b", "c"]),
    ]
    for topo, names in cases:
        want = _outcome(lambda: jax_mesh.mesh_for_topology(topo, names, devs))
        got = _outcome(lambda: port_mesh.mesh_for_topology(
            twin(topo), names, device_type="cpu"))
        assert want[0] == "error" and got == want, (topo.accelerator_type, names)


def test_slice_topology_twin_has_the_fields_the_contract_reads():
    ref = parse_accelerator_type("v5p-16", num_slices=2)
    assert V5P_16_X2 == twin(ref)
    for name in ("total_hosts", "is_multislice", "hosts_per_slice",
                 "num_slices", "ici_mesh", "accelerator_type", "chips"):
        assert getattr(V5P_16_X2, name) == getattr(ref, name), name


def test_dcn_smoke_report_matches_the_reference():
    with one_spawn_at_a_time():
        want = jax_dcn.run_dcn_smoke(local_devices=1)
        got = port_dcn.run_dcn_smoke()
    assert want["ok"], want["errors"]
    assert got["ok"], got["errors"]
    assert list(got) == list(want)
    for key in ("tpu_type", "num_slices", "processes", "procs_per_slice",
                "local_devices", "global_devices", "dcn_psum", "ici_psum",
                "expected_dcn_psum", "expected_ici_psum", "errors"):
        assert got[key] == want[key], key
    assert got["dcn_psum"] == [3.0] and got["ici_psum"] == [3.0]
    assert got["processes"] == 4 and got["local_devices"] == 1
    assert port_dcn.RESULT_MARKER == jax_dcn.RESULT_MARKER


def test_dcn_smoke_on_cards_refuses_fewer_cards_than_processes():
    import torch

    if torch.cuda.device_count() >= V5P_16_X2.total_hosts:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="one rank per card"):
        port_dcn.run_dcn_smoke(device="cuda")


def test_dcn_smoke_entry_point_runs_on_the_cards_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        port_dcn.main([])
