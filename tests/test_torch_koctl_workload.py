"""The port's `koctl workload train|serve|sweep` on the host, against the
reference's `WorkloadService` ops.

The verbs run as a user runs them (`python -m kubeoperator_tpu_torch.cli.
koctl workload ... --cpu --json`): an uninterrupted train, a train drained
at step 2 into a checkpoint directory, a resume of it, serving from the
resumed checkpoint, the sweep. Each record's ``result`` has the keys of the
reference op's result for the same call (the service at world 1 on one
virtual device, checkpoints on, no plan); the drained and resumed losses
equal the uninterrupted run's exactly and the reference's within 1e-5
relative (`tests/test_torch_workloads.py`'s tolerance).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from kubeoperator_tpu_torch.cli import koctl
from kubeoperator_tpu_torch.utils.launch import REPO_ROOT

from tests.test_workloads import workload_stack

LOSS_RTOL = 1e-5


def koctl_workload(*argv: str) -> tuple[int, dict, str]:
    proc = subprocess.run(
        [sys.executable, "-m", "kubeoperator_tpu_torch.cli.koctl", "workload",
         *argv, "--cpu", "--json"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1"))
    return proc.returncode, json.loads(proc.stdout) if proc.stdout else {}, proc.stderr


@pytest.fixture(scope="module")
def verbs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("verbs") / "checkpoints")
    runs = {
        "train": koctl_workload("train", "--steps", "4"),
        "drained": koctl_workload("train", "--steps", "4", "--drain-at", "2",
                                  "--checkpoint-dir", ckpt),
        "resumed": koctl_workload("train", "--resume", "--checkpoint-dir", ckpt),
        "serve": koctl_workload("serve", "--requests", "3", "--checkpoint-dir", ckpt),
        "sweep": koctl_workload("sweep", "--steps", "2"),
    }
    for name, (rc, out, err) in runs.items():
        assert rc == 0 and out["ok"] is True, (name, err[-2000:])
    return {name: out for name, (_, out, _) in runs.items()}


@pytest.fixture(scope="module")
def reference_ops(tmp_path_factory, monkeypatch_module):
    real = jax.devices()
    monkeypatch_module.setattr(jax, "devices", lambda *a, **kw: real[:1])
    svc = workload_stack(tmp_path_factory.mktemp("reference"))
    try:
        wl = svc.workloads

        def drain(completed, _loss):
            if completed == 2:
                wl.request_drain("drill")

        wl.step_hook = drain
        ops = {"drained": wl.train(steps=4)}
        wl.step_hook = None
        ops["resumed"] = wl.train(resume=True)
        ops["serve"] = wl.serve(requests=3)
        ops["sweep"] = wl.sweep(steps=2)
    finally:
        svc.close()
    return ops


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("verb", ["drained", "resumed", "serve", "sweep"])
def test_record_keys_are_the_reference_op_result_keys(verbs, reference_ops, verb):
    assert sorted(verbs[verb]["result"]) == sorted(reference_ops[verb]["result"])
    assert verbs[verb]["kind"] == reference_ops[verb]["kind"]
    assert verbs[verb]["device"]["type"] == "cpu"
    assert verbs[verb]["device"]["kernel_launches"] == {"dma_read": 0,
                                                         "ring_all_gather": 0}


def test_drained_and_resumed_losses_equal_the_uninterrupted_run(verbs, reference_ops):
    drained, resumed = verbs["drained"]["result"], verbs["resumed"]["result"]
    assert drained["drained"] and drained["checkpoint"]["step"] == 2
    assert resumed["resumed_from"] == drained["checkpoint"]["id"]
    assert resumed["start_step"] == 2 and resumed["checkpoint"]["step"] == 4
    losses = drained["losses"] + resumed["losses"]
    assert losses == verbs["train"]["result"]["losses"]
    want = (reference_ops["drained"]["result"]["losses"]
            + reference_ops["resumed"]["result"]["losses"])
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_windows_carry_the_checkpoint_bytes(verbs):
    names = [w["name"] for w in verbs["resumed"]["windows"]]
    assert names == ["compile", "steps", "checkpoint-restore", "checkpoint-save"]
    save = verbs["resumed"]["windows"][-1]
    assert save["attrs"]["bytes"] == verbs["resumed"]["result"]["checkpoint"]["bytes"]
    assert save["end"] >= save["start"]
    serve = verbs["serve"]
    assert serve["result"]["checkpoint_restored"] \
        == verbs["resumed"]["result"]["checkpoint"]["id"]
    assert [w["name"] for w in serve["windows"]] \
        == ["checkpoint-restore", "serve-compile", "serving"]


def test_refusals_exit_2_with_the_reason(tmp_path, capsys):
    for argv, reason in (
            (["serve", "--checkpoint-dir", str(tmp_path)], "no complete checkpoint"),
            (["train", "--resume"], "--resume reads --checkpoint-dir"),
            (["train", "--steps", "1"], "steps >= 2")):
        assert koctl.main(["workload", *argv, "--cpu"]) == 2
        assert reason in capsys.readouterr().err
