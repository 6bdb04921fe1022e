"""Each plain reference against the port at a tiny size on the CPU, both in
float32, where they compute the same function: every number the check
compares then agrees to float32 rounding. On the card the program runs in
bfloat16 against the float32 reference; the gap there is that precision."""

import json

import pytest
import torch

from kobench import compare, harness, inputs
from kobench.reference import dense_stage, precision

SEED = 2 ** 31 + 11


def _f32_cell(root, name):
    cell = harness.load_cell(root, name)
    cell.config = dict(cell.config, dtype="float32")
    return cell


def test_the_reference_draws_the_entrys_batch(tiny_root):
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.workloads.step import build_batch

    from kobench.drivers.train_dense import _net_config

    cfg = harness.load_cell(tiny_root, "dense-train").config
    initialize_from_env("cpu")
    mesh = MeshSpec(axes=tuple(cfg["mesh"].items())).build("cpu")
    ours = dense_stage.entry_batch(cfg, SEED, "cpu")
    assert torch.equal(ours.view(torch.int16),
                       build_batch(mesh, _net_config(cfg), seed=SEED + 1).view(torch.int16))


def test_dense_reference_is_the_ports_adamw_steps(tiny_root):
    from kobench.drivers import train_dense

    cell = _f32_cell(tiny_root, "dense-train")
    _, prog = train_dense.program_run(cell, SEED, 0.0, False, "cpu")
    ref = train_dense.reference_outputs(cell, SEED, torch.device("cpu"))
    got = compare.train_readings(prog, ref)
    assert max(got.values()) < 2e-4, got


def test_vnet_reference_is_the_ports_sharded_step_on_four_ranks(tiny_root):
    """Four gloo ranks on (dp, pp, sp, tp) = (1, 1, 2, 2): ring attention,
    the MoE routing across sp and the tp sum against one device."""
    from kobench.drivers import train_vnet

    cfg_path = tiny_root / "kobench/configs/validation-net-bench.json"
    cfg = json.loads(cfg_path.read_text())
    cfg_path.write_text(json.dumps(dict(cfg, dtype="float32")))
    cell = harness.load_cell(tiny_root, "vnet-train-4chip")
    out = train_vnet.run_jobs(cell, [{"seed": SEED, "seconds": 0.0,
                                      "trace": False}], "cpu")[0]
    assert max(out["readings"].values()) < 2e-4, out["readings"]


def test_dense_reference_is_the_ports_forward(tiny_root):
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.workloads import serve

    from kobench.drivers.train_dense import _net_config

    cfg = dict(harness.load_cell(tiny_root, "dense-serve").config, dtype="float32")
    initialize_from_env("cpu")
    mesh = MeshSpec(axes=tuple(cfg["mesh"].items())).build("cpu")
    fn, _, _ = serve.make_forward(mesh, _net_config(cfg))
    gen = inputs.generator(SEED, "cpu")
    p = inputs.normal_tree(dense_stage.weight_shapes(cfg), gen, torch.float32, 0.05)
    x = inputs.normal((cfg["b_local"], cfg["s_local"], cfg["d_model"]), gen,
                      torch.float32)
    y = fn(dict(p, step=torch.zeros(())), x)
    ref = dense_stage.serve(p, x, cfg, precision.product("f32"))
    assert compare.token_err(y.shape, y, ref, range(len(y))) < 1e-4


def test_fp8_control_rounds_every_product():
    a = torch.randn(32, 32)
    mm = precision.product("fp8")
    exact = precision.product("f32")(a, a)
    gap = float((mm(a, a) - exact).norm() / exact.norm())
    assert 1e-3 < gap < 0.2
    with pytest.raises(ValueError):
        precision.product("int3")
