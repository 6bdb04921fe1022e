"""The port's GPU registry, errors, mesh and host-state conversion."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from kubeoperator_tpu.parallel.topology import TpuGeneration
from kubeoperator_tpu.utils.errors import TopologyError as JaxTopologyError
from kubeoperator_tpu_torch.parallel.mesh import build_mesh
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.topology import (
    GENERATIONS,
    GpuGeneration,
    generation_for_device,
    generation_for_name,
)
from kubeoperator_tpu_torch.utils.errors import TopologyError
from kubeoperator_tpu_torch.weights import from_jax_host


@pytest.mark.parametrize("name, entry, gbps, tflops", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm", 3350.0, 989.0),
    ("NVIDIA H100 SXM5 80GB", "h100-sxm", 3350.0, 989.0),
    ("NVIDIA H100 PCIe", "h100-pcie", 2000.0, 756.0),
    ("NVIDIA H100 NVL", "h100-nvl", 3900.0, 835.0),
])
def test_h100_names_map_to_their_entries(name, entry, gbps, tflops):
    gen = generation_for_name(name)
    assert gen is GENERATIONS[entry]
    assert (gen.hbm_gbps_per_chip, gen.bf16_tflops_per_chip) == (gbps, tflops)


@pytest.mark.parametrize("name", [
    "NVIDIA A100-SXM4-80GB", "NVIDIA H200", "NVIDIA GH200 480GB", "cpu", "",
])
def test_unknown_parts_give_none(name):
    assert generation_for_name(name) is None


def test_cpu_device_gives_none():
    assert generation_for_device(torch.device("cpu")) is None


def test_fields_the_diag_reads_exist_in_both_registries():
    port = {f.name for f in dataclasses.fields(GpuGeneration)}
    ref = {f.name for f in dataclasses.fields(TpuGeneration)}
    assert {"name", "hbm_gbps_per_chip", "bf16_tflops_per_chip"} <= port & ref


def test_topology_error_code_matches_reference():
    assert TopologyError.code == JaxTopologyError.code
    assert TopologyError.http_status == JaxTopologyError.http_status
    assert TopologyError("x").to_dict() == JaxTopologyError("x").to_dict()


def test_mesh_shape_mismatch_raises_topology_error():
    initialize_from_env("cpu")
    assert build_mesh(("data", "model"), device_type="cpu").shape == (1, 1)
    with pytest.raises(TopologyError):
        build_mesh(("data",), (2,), device_type="cpu")


def test_from_jax_host_keeps_nesting_values_and_dtypes():
    host = {
        "params": {"w_in": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "step": np.int32(3)},
        "bf16": np.array([1.5, -2.0], dtype=ml_dtypes.bfloat16),
    }
    got = from_jax_host(host, device="cpu")
    assert torch.equal(got["params"]["w_in"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert got["params"]["step"].dtype == torch.int32
    assert int(got["params"]["step"]) == 3
    assert got["bf16"].dtype == torch.bfloat16
    assert got["bf16"].tolist() == [1.5, -2.0]
