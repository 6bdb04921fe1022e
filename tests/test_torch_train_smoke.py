"""The port's train smoke against the JAX package's, on the host: the result
keys and the MFU convention, the losses at world 1, the gate folding a
`train` block into its verdict with KO_TPU_TRAIN_STEPS>0 (and adding none
at 0), `koctl tpu train-smoke --cpu`, and at 2 gloo ranks the gate with
training over mesh (1,1,1,2) (the tp all-reduce pair) and the (dp=2,
b_local=2) step.

Tolerances: the f32 losses within 1e-5 relative and f32 parameters after a
step within 1e-7 absolute, as in tests/test_torch_validation_net.py (same
f32 arithmetic in other summation orders; the step moves parameters by
1e-4 to 1e-3).
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

from kubeoperator_tpu.ops import psum_smoke as jax_smoke
from kubeoperator_tpu.ops import train_smoke as jax_train
from kubeoperator_tpu_torch.cli import koctl
from kubeoperator_tpu_torch.ops import psum_smoke as port_smoke
from kubeoperator_tpu_torch.ops import train_smoke as port_train
from kubeoperator_tpu_torch.parallel import validation_net as pv

from tests.test_torch_ops import spawn_ranks
from tests.test_torch_validation_net import (
    LOSS_RTOL_F32,
    PARAM_ATOL_F32,
    _jax_steps,
    _port_world_one,
)


@pytest.fixture(autouse=True)
def _no_gate_env(monkeypatch):
    monkeypatch.delenv("KO_TPU_TRAIN_STEPS", raising=False)
    monkeypatch.delenv("KO_TPU_EXPECTED_CHIPS", raising=False)


def test_result_keys_match_reference():
    port = port_train.run_train_smoke(steps=2, device="cpu")
    ref = jax_train.run_train_smoke(steps=2, devices=jax.devices()[:1])
    assert list(port) == list(ref)
    assert port["mesh"] == ref["mesh"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 1}
    assert port["ok"] is True and port["finite"] and port["descending"]
    assert port["devices"] == 1
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL_F32)
    with_peak = port_train.run_train_smoke(steps=2, device="cpu",
                                           peak_tflops_per_chip=989.0)
    assert list(with_peak) == list(ref) + ["mfu_pct"]


def test_single_step_runs_exactly_once():
    result = port_train.run_train_smoke(steps=1, device="cpu")
    assert len(result["losses"]) == 1
    assert result["ok"] is True and result["descending"] is True
    assert result["steps_per_s"] == 0.0


def test_model_flops_and_mfu_follow_the_reference_convention():
    result = port_train.run_train_smoke(steps=3, device="cpu",
                                        peak_tflops_per_chip=197.0)
    flops = pv.analytic_train_flops(pv.mesh_spec_for(1))
    want = result["steps_per_s"] * flops / 1e12
    assert abs(result["model_tflops_per_s"] - want) < max(1e-4, want * 0.01)
    assert abs(result["mfu_pct"]
               - 100.0 * result["model_tflops_per_s"] / 197.0) < 0.01
    # without a peak, no mfu key is made up
    assert "mfu_pct" not in port_train.run_train_smoke(steps=1, device="cpu")


def test_non_finite_losses_fail_the_smoke(monkeypatch):
    real = pv.make_train_step

    def nan_step(mesh, lr=None, cfg=None):
        step = real(mesh, lr=lr, cfg=cfg)

        def run(params, x):
            loss, params = step(params, x)
            return loss * float("nan"), params
        return run

    monkeypatch.setattr(pv, "make_train_step", nan_step)
    result = port_train.run_train_smoke(steps=2, device="cpu")
    assert result["finite"] is False and result["ok"] is False


def _smoke(run_smoke, **kw):
    return run_smoke(sizes_mb=(0.01,), iters=2, **kw)


def test_zero_train_steps_add_no_train_block(monkeypatch):
    # KO_TPU_TRAIN_STEPS=0 is the gate without training, in both packages
    monkeypatch.setenv("KO_TPU_TRAIN_STEPS", "0")
    monkeypatch.setattr(port_smoke, "run_train_smoke", None)
    port = _smoke(port_smoke.run_smoke, device="cpu")
    ref = _smoke(jax_smoke.run_smoke)
    assert list(port) == list(ref) and "train" not in port
    assert port["ok"] is ref["ok"] is True


@pytest.mark.parametrize("train_ok", [True, False])
def test_gate_verdict_follows_the_train_verdict(monkeypatch, train_ok):
    monkeypatch.setenv("KO_TPU_TRAIN_STEPS", "3")
    seen = []

    def fake(steps=4, **kw):
        seen.append(steps)
        return {"ok": train_ok}

    monkeypatch.setattr(port_smoke, "run_train_smoke", fake)
    monkeypatch.setattr(jax_train, "run_train_smoke", fake)
    port = _smoke(port_smoke.run_smoke, device="cpu")
    ref = _smoke(jax_smoke.run_smoke)
    assert seen == [3, 3]
    assert port["ok"] is ref["ok"] is train_ok
    assert port["train"] == ref["train"] == {"ok": train_ok}


def test_main_prints_the_train_marker_line(capsys):
    assert port_train.main("cpu") == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("KO_TPU_TRAIN_RESULT ")]
    assert len(lines) == 1
    assert len(json.loads(lines[0].split(" ", 1)[1])["losses"]) == 4


def test_koctl_train_smoke_on_the_host():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = koctl.main(["tpu", "train-smoke", "--steps", "2", "--cpu"])
    result = json.loads(buf.getvalue())
    assert rc == 0 and result["ok"] is True
    assert len(result["losses"]) == 2


def test_koctl_train_smoke_exits_1_when_not_ok(monkeypatch, capsys):
    from kubeoperator_tpu_torch import ops

    monkeypatch.setattr(ops, "run_train_smoke",
                        lambda **kw: {"ok": False, "losses": [1.0, 2.0]})
    assert koctl.main(["tpu", "train-smoke", "--cpu"]) == 1
    assert json.loads(capsys.readouterr().out)["ok"] is False


# ------------------------------------------------------- 2 gloo ranks ----
_RANK_SCRIPT = """
import json, os, numpy as np, torch, torch.distributed as dist
from kubeoperator_tpu_torch.ops import psum_smoke
from kubeoperator_tpu_torch.parallel import validation_net as vnet
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
initialize_from_env("cpu")
rank = dist.get_rank()
os.environ["KO_TPU_TRAIN_STEPS"] = "2"
out = {{"rank": rank, "smoke": psum_smoke.run_smoke(sizes_mb=(0.01,), iters=2,
                                                   device="cpu")}}
mesh = MeshSpec(axes=(("dp", 2), ("pp", 1), ("sp", 1), ("tp", 1))).build("cpu")
cfg = vnet.NetConfig(b_local=2, remat="none")
params, x, _ = vnet.build_params_and_batch(mesh, cfg=cfg)
loss, params = vnet.make_train_step(mesh, cfg=cfg)(params, x)
out["dp_loss"] = float(loss)
np.savez(os.path.join({out_dir!r}, f"dp-{{rank}}.npz"),
         **{{k: v.numpy() for k, v in params.items()}})
dist.barrier()
print("RANK_RESULT " + json.dumps(out), flush=True)
os._exit(0)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_shards")
    return spawn_ranks(2, _RANK_SCRIPT.format(out_dir=str(out))), out


def test_gate_with_training_at_two_ranks(two_ranks):
    ranks, _ = two_ranks
    ref = jax_train.run_train_smoke(steps=2, devices=jax.devices()[:2])
    assert ref["mesh"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 2}
    for r in ranks:
        smoke = r["smoke"]
        assert smoke["ok"] is True and smoke["chips"] == 2
        train = smoke["train"]
        assert train["ok"] is True and train["devices"] == 2
        assert train["mesh"] == ref["mesh"]
        np.testing.assert_allclose(train["losses"], ref["losses"],
                                   rtol=LOSS_RTOL_F32)


def test_the_update_is_invariant_under_dp(two_ranks):
    # (dp=2, b_local=2) takes the same step as (dp=1, b_local=4), and as
    # the reference's (dp=2, b_local=2)
    ranks, out = two_ranks
    losses, ref_first, _ = _port_world_one(b_local=4, remat="none")
    jax_losses, jax_first, _ = _jax_steps((2, 1, 1, 1), 2, "none", 1)
    for r in ranks:
        np.testing.assert_allclose(r["dp_loss"], losses[0], rtol=LOSS_RTOL_F32)
        np.testing.assert_allclose(r["dp_loss"], jax_losses[0], rtol=LOSS_RTOL_F32)
        got = np.load(out / f"dp-{r['rank']}.npz")
        for k, ref in ref_first.items():   # every parameter is replicated on dp
            np.testing.assert_allclose(got[k], ref, rtol=0, atol=PARAM_ATOL_F32,
                                       err_msg=k)
            np.testing.assert_allclose(got[k], jax_first[k], rtol=0,
                                       atol=PARAM_ATOL_F32, err_msg=k)
