"""The reference's chaos soaks driven through the port's device seams, on
the host: the preemption drill's loss scenario
(`kubeoperator_tpu/cli/koctl.py::_preemption_soak_once`) and the queue drill
(`_queue_soak_once`). `tests/test_torch_soaks_multislice.py` holds the two
soaks whose full mesh takes 8 ranks (notice, serve).

Each soak runs twice with `tests/test_slicepool.py::drill_args`: pure JAX,
and with the port's seams injected (`tests/test_torch_service.py::use_port`
with 8 ranks visible, so the soak's own ``jax.devices()`` and the slice
pool's device count read 8 as in pure JAX). The soaks are never edited:
their library reference runs reach the same module attributes, so they run
through the port too. Every run either pass makes through those attributes
is recorded (`record_runs`), so the device runs are compared one by one,
not only through the soaks' verdicts.

Held: every check ``ok`` in both passes, the same check names in the same
order, the structural summaries equal key by key, and losses and serving
digests within 1e-5 relative of pure JAX's (the tolerance of
`tests/test_torch_service.py`: the same f32 arithmetic in another summation
order). The soaks' own bit-for-bit checks (a degraded or resumed run equal
to its reference) hold within each pass; they are in the check lists.

Every relayed run here has at most 4 ranks: the degrade leg and the fresh
run are data=1,fsdp=4, and so are the queue's gangs (one lane).

The preemption soak runs once more at a width where a from-scratch 4-step
run's losses rise (`RISING`): there the reference fails exactly its
"continued" check, and the port must fail exactly it too.
"""

import functools

import numpy as np
import pytest

from kubeoperator_tpu.cli import koctl as jkoctl
from kubeoperator_tpu.parallel import validation_net as jv
from kubeoperator_tpu.workloads import harness as jh
from kubeoperator_tpu.workloads import serve as jserve
from kubeoperator_tpu_torch.parallel import validation_net as pv
from kubeoperator_tpu_torch.service import workload as sw

from tests.test_slicepool import drill_args
from tests.test_torch_ops import one_spawn_at_a_time
from tests.test_torch_service import LOSS_RTOL, use_port

SOAK_DEVICES = 8           # the soaks' 2 x v5e-4 cluster
NUMERIC = ("losses", "reference", "outputs", "reference_outputs")
# a width at which a from-scratch 4-step run on data=1,fsdp=4 ends above its
# first loss (global batch 8): the reference's verdict on it is not ok
RISING = dict(d_model=512, d_ff=4096, heads=8, b_local=2, s_local=128)


def record_runs(mp, log: list) -> None:
    """Wrap the seams now in place (the reference's or the port's) so that
    every training and serving run appends what it did to `log`."""
    def wrap(module, name, kind):
        inner = getattr(module, name)

        def recorded(mesh, *args, **kw):
            out = inner(mesh, *args, **kw)
            log.append({
                "kind": kind, "mesh": str(sw.mesh_axes(mesh)),
                "start_step": out.get("start_step"),
                "end_step": out.get("end_step"),
                "degraded": out.get("degraded"),
                "values": list(out["losses"] if kind == "train"
                               else out["outputs"])})
            return out

        mp.setattr(module, name, recorded)

    wrap(jh, "run_training", "train")
    wrap(jserve, "run_serving", "serve")


def soak_pass(name: str, base_dir, port: bool, net: dict | None = None) -> dict:
    """One pass of `_<name>_soak_once`: its checks, its structure and the
    runs it made, pure JAX or through the port (the one-spawn lock held
    once around the whole soak: the serve soak's two lanes relay at once).
    `net` widens every training run's NetConfig from the default."""
    runs: list = []
    soak = getattr(jkoctl, f"_{name}_soak_once")
    with pytest.MonkeyPatch.context() as mp:
        if port:
            mp.setenv("OMP_NUM_THREADS", "1")
            use_port(mp, SOAK_DEVICES,
                     **({"cfg": pv.NetConfig(**net)} if net else {}))
        elif net:
            mp.setattr(jh, "run_training", functools.partial(
                jh.run_training, cfg=jv.NetConfig(**net)))
        record_runs(mp, runs)
        if port:
            with one_spawn_at_a_time():
                checks, structure = soak(drill_args(seed=1), str(base_dir))
        else:
            checks, structure = soak(drill_args(seed=1), str(base_dir))
    return {"checks": checks, "structure": structure, "runs": runs}


def both_passes(tmp_path_factory, name: str, net: dict | None = None) -> dict:
    return {"jax": soak_pass(name, tmp_path_factory.mktemp(f"{name}-jax"),
                             False, net),
            "port": soak_pass(name, tmp_path_factory.mktemp(f"{name}-port"),
                              True, net)}


def assert_all_checks_pass(passes: dict) -> None:
    for which, ran in passes.items():
        failed = [c for c in ran["checks"] if not c["ok"]]
        assert not failed, (which, failed)
    assert [c["check"] for c in passes["port"]["checks"]] \
        == [c["check"] for c in passes["jax"]["checks"]]


def assert_same_structure(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key in NUMERIC:
            assert len(got[key]) == len(value), key
            np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL,
                                       err_msg=key)
        else:
            assert got[key] == value, key


def _run_key(run: dict) -> tuple:
    return (run["kind"], run["mesh"], run["start_step"], len(run["values"]))


def assert_same_runs(passes: dict) -> None:
    """The same device runs in both passes (by kind, mesh, start step and
    length; a stable sort keeps each lane's call order), each run's losses
    or digests within the tolerance."""
    got = sorted(passes["port"]["runs"], key=_run_key)
    want = sorted(passes["jax"]["runs"], key=_run_key)
    assert [_run_key(r) for r in got] == [_run_key(r) for r in want]
    for g, w in zip(got, want):
        assert (g["end_step"], g["degraded"]) == (w["end_step"], w["degraded"])
        np.testing.assert_allclose(g["values"], w["values"], rtol=LOSS_RTOL,
                                   err_msg=str(_run_key(w)))


def ranks_of(mesh: str) -> int:
    return sw.mesh_axes(mesh).total_devices


@pytest.fixture(scope="module")
def preemption(tmp_path_factory):
    return both_passes(tmp_path_factory, "preemption")


@pytest.fixture(scope="module")
def preemption_rising(tmp_path_factory):
    return both_passes(tmp_path_factory, "preemption", RISING)


@pytest.fixture(scope="module")
def queue(tmp_path_factory):
    return both_passes(tmp_path_factory, "queue")


@pytest.fixture(params=["preemption", "queue"])
def soak(request):
    return request.getfixturevalue(request.param)


def test_every_check_passes_in_both_passes(soak):
    assert_all_checks_pass(soak)


def test_structures_match_key_by_key(soak):
    assert_same_structure(soak["port"]["structure"], soak["jax"]["structure"])


def test_every_device_run_matches_the_pure_jax_run(soak):
    assert_same_runs(soak)
    assert soak["port"]["runs"], "the soak made no device run"
    assert max(ranks_of(r["mesh"]) for r in soak["port"]["runs"]) <= 4


def test_preemption_degrade_leg_ran_from_scratch_on_the_survivor(preemption):
    # the loss scenario: no tenant checkpoint, so the degrade leg and the
    # soak's fresh run both start at step 0 on data=1,fsdp=4, and are equal
    runs = preemption["port"]["runs"]
    assert [(r["mesh"], r["start_step"]) for r in runs] \
        == [("data=1,fsdp=4,tp=1", 0)] * 2
    assert runs[0]["values"] == runs[1]["values"]
    assert preemption["port"]["structure"]["shrunk_axis"] == "data"


def test_queue_alice_resumes_where_she_was_drained(queue):
    runs = queue["port"]["runs"]
    alice = [r for r in runs if len(r["values"]) in (2, 4)]
    assert [(r["start_step"], r["end_step"]) for r in alice] == [(0, 2), (2, 6)]
    reference = next(r for r in runs if len(r["values"]) == 6)
    assert alice[0]["values"] + alice[1]["values"] == reference["values"]


def test_where_the_losses_rise_both_fail_only_the_continued_check(
        preemption_rising):
    # AdamW's first sign step overshoots at this width, so the degrade leg's
    # from-scratch losses end above their first: the reference's verdict
    # rule fails "continued" in pure JAX, and the port is held to the same
    # outcome (on the card, chip_smoke.py phase 18 accepts it at
    # BENCH_CONFIG width, and only it); parity with the fresh run holds
    for which, ran in preemption_rising.items():
        failed = [c["check"] for c in ran["checks"] if not c["ok"]]
        assert failed == ["workload continued on the degraded mesh "
                          "(4 devices)"], which
        losses = ran["structure"]["losses"]
        assert losses[-1] > losses[0], which
    assert [c["check"] for c in preemption_rising["port"]["checks"]] \
        == [c["check"] for c in preemption_rising["jax"]["checks"]]
    assert_same_structure(preemption_rising["port"]["structure"],
                          preemption_rising["jax"]["structure"])
    assert_same_runs(preemption_rising)
