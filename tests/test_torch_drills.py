"""The port's `koctl chaos-soak --preemption|--queue|--serve`: the device half
of the reference's soaks (`kubeoperator_tpu_torch/service/drills.py`), on
the host.

Each verb runs once as a user runs it, in a subprocess with ``--cpu
--format json`` at ``--mesh data=2,fsdp=2`` (4 gloo ranks through the
callback relay; the survivor mesh data=1,fsdp=2). Held:

* exit 0 with the reference's report keys (`cmd_preemption_soak`,
  `cmd_queue_soak`, `cmd_serve_soak`);
* the drills' own equality checks (a degraded or resumed run equal to its
  reference) hold exactly: every check is ``ok``;
* their losses and serving digests within 1e-5 relative of the reference
  library (`harness.run_training`, `serve.run_serving`) on the same layouts
  over the virtual CPU devices, the tolerance of
  `tests/test_torch_service.py`.

In process: at ``data=1`` nothing can be lost (``shrunk_axis`` None, no
reshard), `--verify-determinism` reports two equal passes, a mesh larger
than the visible count is refused before any run, and at a width where the
losses rise only the degrade leg's "continued" check fails, the reference's
verdict on the same run.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from kubeoperator_tpu.parallel import validation_net as jv
from kubeoperator_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.workloads import harness as jh
from kubeoperator_tpu.workloads import serve as jserve
from kubeoperator_tpu_torch.cli import koctl
from kubeoperator_tpu_torch.parallel import validation_net as pv
from kubeoperator_tpu_torch.service import drills
from kubeoperator_tpu_torch.utils.errors import ValidationError

from tests.test_torch_ops import one_spawn_at_a_time
from tests.test_torch_service import LOSS_RTOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = "data=2,fsdp=2"
FULL, SURVIVOR = "data=2,fsdp=2,tp=1", "data=1,fsdp=2,tp=1"
WORLD_ONE = "data=1,fsdp=1,tp=1"
# a width at which a from-scratch 4-step run ends above its first loss
# (global batch 8), the reference's as the port's
RISING = dict(d_model=512, d_ff=4096, heads=8, b_local=8, s_local=128)
REPORT_KEYS = {"seed", "checks", "structure", "runtime_s"}
DRILL_NAMES = ("preemption", "queue", "serve")


def run_verb(which: str, *extra: str) -> tuple[int, dict]:
    """`koctl chaos-soak --<which> --cpu --format json` as a subprocess."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with one_spawn_at_a_time():
        proc = subprocess.run(
            [sys.executable, "-m", "kubeoperator_tpu_torch.cli.koctl",
             "chaos-soak", f"--{which}", "--cpu", "--format", "json", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.stdout, proc.stderr[-3000:]
    return proc.returncode, json.loads(proc.stdout)


@pytest.fixture(scope="module")
def reports():
    return {which: run_verb(which, "--mesh", MESH) for which in DRILL_NAMES}


# ------------------------------------------------- the reference library ----
def jax_train(spec: str, steps: int, state=None, stop_at=None, keep=False):
    n = JaxMeshSpec.parse(spec).total_devices
    run = jh.run_training(
        JaxMeshSpec.parse(spec).build(jax.devices()[:n]), steps=steps,
        mode="auto", seed=0, state=state, return_state=keep,
        on_step=(lambda completed, _l: completed >= stop_at) if stop_at else None)
    if keep:
        run["state"] = jax.tree_util.tree_map(
            lambda leaf: np.asarray(jax.device_get(leaf)), run["state"])
    return run


def jax_serve(params, reshard: bool):
    mesh = JaxMeshSpec.parse(FULL).build(jax.devices()[:4])
    survivor = JaxMeshSpec.parse(SURVIVOR)
    return jserve.run_serving(
        mesh, params=params, requests=drills.SERVE_REQUESTS, mode="auto",
        seed=0, on_request=(lambda served, _l: ("reshard", survivor)
                            if reshard and served == drills.RESHARD_AT else None))


def close(got, want) -> None:
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def resumed_on(spec: str, drained_on: str, total: int, at: int, steps: int):
    """The reference's drained-at-`at` state continued on `spec`."""
    drained = jax_train(drained_on, total, stop_at=at, keep=True)
    return jax_train(spec, steps, state=drained["state"])


# ------------------------------------------------------------- the verbs ----
@pytest.mark.parametrize("which", DRILL_NAMES)
def test_verb_exits_0_with_the_reference_report_keys(reports, which):
    rc, report = reports[which]
    assert rc == 0, [c for c in report["checks"] if not c["ok"]]
    assert REPORT_KEYS <= set(report) and "deterministic" not in report
    assert (report["mesh"], report["survivor_mesh"]) == (FULL, SURVIVOR)
    assert report["device"]["type"] == "cpu" and report["device"]["count"] == 4
    assert all(set(c) == {"check", "ok", "detail"} for c in report["checks"])


@pytest.mark.parametrize("which", DRILL_NAMES)
def test_every_check_holds(reports, which):
    checks = reports[which][1]["checks"]
    assert checks and all(c["ok"] for c in checks), checks


def test_preemption_drill_matches_the_reference_library(reports):
    loss = reports["preemption"][1]["structure"]["loss"]
    notice = reports["preemption"][1]["structure"]["notice"]
    assert (loss["degraded_mesh"], loss["shrunk_axis"]) == (SURVIVOR, "data")
    close(loss["losses"], jax_train(SURVIVOR, drills.RESHARD_STEPS)["losses"])
    reference = jax_train(FULL, drills.NOTICE_STEPS)["losses"]
    close(notice["reference"], reference)
    assert notice["losses"] == notice["reference"]
    assert notice["checkpoint_step"] == drills.NOTICE_AT
    # the degrade leg: the checkpoint of 4 ranks continued on 2
    close(notice["degraded_losses"], resumed_on(
        SURVIVOR, FULL, drills.NOTICE_STEPS, drills.NOTICE_AT,
        drills.RESHARD_STEPS)["losses"])


def test_queue_drill_matches_the_reference_library(reports):
    structure = reports["queue"][1]["structure"]
    assert structure["gang_mesh"] == SURVIVOR
    assert structure["order"] == [["alice", 0], ["carol", 0], ["bob", 0],
                                  ["alice", drills.PREEMPT_AT]]
    close(structure["reference"], jax_train(SURVIVOR, drills.QUEUE_STEPS)["losses"])
    assert structure["losses"] == structure["reference"]


def test_serve_drill_matches_the_reference_library(reports):
    structure = reports["serve"][1]["structure"]
    sierra = jax_train(FULL, drills.SIERRA_STEPS, keep=True)
    params = sierra["state"]["params"]
    close(structure["reference_outputs"], jax_serve(params, False)["outputs"])
    degraded = jax_serve(params, True)
    close(structure["outputs"], degraded["outputs"])
    assert structure["degraded_mesh"] == degraded["mesh"] \
        == {"data": 1, "fsdp": 2, "tp": 1}
    assert structure["outputs"][:2] == structure["reference_outputs"][:2]
    close(structure["reference"], jax_train(SURVIVOR, drills.TINA_STEPS)["losses"])
    assert structure["losses"] == structure["reference"]
    close(structure["uma_losses"], jax_train(SURVIVOR, drills.SHORT_STEPS)["losses"])


def test_serve_drill_windows_carry_latencies_and_checkpoint_bytes(reports):
    windows = reports["serve"][1]["windows"]
    serving = [w for w in windows if w["name"] == "serving"]
    assert [w["attrs"]["run"] for w in serving] == ["serve/reference",
                                                    "serve/server"]
    assert all(w["attrs"]["latency_p50_ms"] > 0 for w in serving)
    saves = [w for w in windows if w["name"] == "checkpoint-save"]
    assert [w["attrs"]["run"] for w in saves] == ["serve/sierra", "serve/tina"]
    assert all(w["attrs"]["bytes"] > 0 for w in saves)


# ------------------------------------------------------------ in process ----
def soak_in_process(*argv: str) -> tuple[int, dict]:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = koctl.main(["chaos-soak", "--cpu", "--format", "json", *argv])
    return rc, json.loads(out.getvalue())


@pytest.mark.parametrize("which", DRILL_NAMES)
def test_one_device_loses_no_slice_and_passes_twice_alike(which):
    rc, report = soak_in_process(f"--{which}", "--mesh", "data=1",
                                 "--verify-determinism")
    assert rc == 0 and report["deterministic"] is True
    assert report["mesh"] == report["survivor_mesh"] == "data=1,fsdp=1,tp=1"
    structure = report["structure"]
    if which == "preemption":
        assert structure["loss"]["shrunk_axis"] is None
        assert not any("shrank" in c["check"] for c in report["checks"])
    if which == "serve":
        assert structure["shrunk_axis"] is None
        assert structure["outputs"] == structure["reference_outputs"]
    assert all(c["ok"] for c in report["checks"])


def test_where_the_losses_rise_only_the_continued_check_fails(tmp_path):
    # at a width where AdamW's first sign step overshoots, a from-scratch
    # 4-step run ends above its first loss: the reference's verdict (``ok``
    # = finite and descending) is not ok, so the degrade leg's "continued"
    # check fails and nothing else does, as on the card at BENCH_CONFIG
    # width in f32 (chip_smoke.py phase 18 accepts exactly this outcome;
    # tests/test_torch_soaks.py holds the reference soak to the same)
    checks, structure = drills.preemption_drill(
        "data=1", pv.NetConfig(**RISING), device="cpu", visible=[0],
        work_dir=str(tmp_path))
    assert [c["check"] for c in checks if not c["ok"]] == [
        "[loss] workload continued on the survivor mesh (the full mesh: one "
        "device loses no slice) (1 device)"]
    reference = jh.run_training(JaxMeshSpec.parse(WORLD_ONE).build(
        jax.devices()[:1]), jv.NetConfig(**RISING), steps=drills.RESHARD_STEPS)
    assert not reference["ok"] and reference["losses"][-1] > reference["losses"][0]
    close(structure["loss"]["losses"], reference["losses"])
    assert structure["notice"]["losses"] == structure["notice"]["reference"]


@pytest.mark.parametrize("which", DRILL_NAMES)
def test_a_mesh_larger_than_the_visible_count_is_refused(tmp_path, which):
    with pytest.raises(ValidationError, match="needs 4 devices, 3 visible"):
        drills.DRILLS[which](MESH, device="cpu", visible=[0, 1, 2],
                             work_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_a_mesh_that_cannot_lose_a_slice_is_refused():
    # tp factors the model: the planner never shrinks it, as the slice
    # pool's planner refuses it
    from kubeoperator_tpu_torch.utils.errors import TopologyError

    with pytest.raises(TopologyError, match="cannot re-shard"):
        drills.plan("tp=2")
