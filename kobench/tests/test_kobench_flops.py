"""The frozen FLOP counts equal the port's at several shapes today."""

import pytest

from kobench import flops
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig, analytic_train_flops
from kubeoperator_tpu_torch.workloads.step import analytic_step_flops

SHAPES = [dict(d_model=4096, d_ff=32768, heads=8, b_local=48, s_local=1024),
          dict(d_model=512, d_ff=4096, heads=8, b_local=2, s_local=128),
          dict(d_model=64, d_ff=128, heads=4, b_local=3, s_local=16)]


@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("mesh", [{"data": 1, "fsdp": 1, "tp": 1},
                                  {"data": 2, "fsdp": 2, "tp": 2}])
def test_dense_step_flops_are_the_ports(dims, mesh):
    spec = MeshSpec(axes=tuple(mesh.items()))
    assert flops.dense_step_flops(dims, mesh) == analytic_step_flops(spec, NetConfig(**dims))


@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("mesh", [{"dp": 1, "pp": 1, "sp": 1, "tp": 1},
                                  {"dp": 1, "pp": 1, "sp": 2, "tp": 2},
                                  {"dp": 2, "pp": 2, "sp": 2, "tp": 2}])
def test_vnet_step_flops_are_the_ports(dims, mesh):
    spec = MeshSpec(axes=tuple(mesh.items()))
    assert flops.vnet_step_flops(dims, mesh) == analytic_train_flops(spec, NetConfig(**dims))
