"""The check of the check, at a size a test run holds, with each cell's
committed limits: a sound run comes out correct, the control (the plain
reference in fp8 in the program's place) does not, and neither does a run
with each fault the cell can have planted under its timed path
(`kobench/faults.py`). The harness's look for a card is skipped; the rest
of a run, the result line included, is driven on the CPU."""

import pytest

from kobench import harness

SEED = 2 ** 31 + 5
ONE_CARD = {"dense-train": ("half_batch", "unchanged"),
            "dense-serve": ("half_batch", "altered")}
VNET = {"vnet-train-4chip": ("half_batch", "unchanged", "no_exchange")}


def _correct(cell, outcome) -> bool:
    return harness.result(cell, outcome, False, 1.0)["correct"]


def _readings_correct(cell, readings) -> bool:
    return harness.passed(harness.checks(readings, cell.traffic["limits"]))


@pytest.mark.parametrize("name", sorted(ONE_CARD))
def test_sound_run_is_correct_and_the_control_is_not(tiny_root, name):
    cell = harness.load_cell(tiny_root, name)
    drv = harness.driver(cell)
    assert _correct(cell, drv.run(cell, SEED, 0.3, False, "cpu"))
    assert not _readings_correct(cell, drv.control(cell, SEED, "cpu"))


@pytest.mark.parametrize("name, fault", [(n, f) for n, fs in sorted(ONE_CARD.items())
                                         for f in fs])
def test_a_planted_fault_is_not_correct(tiny_root, name, fault):
    cell = harness.load_cell(tiny_root, name)
    out = harness.driver(cell).run(cell, SEED, 0.3, False, "cpu", fault)
    assert not _correct(cell, out)


@pytest.fixture(scope="module", params=sorted(VNET))
def vnet_runs(request, tmp_path_factory):
    """One set of gloo ranks per cell: a sound run, the control, each
    fault the cell can have."""
    from kobench.drivers import train_vnet
    from kobench.tests.conftest import TINY, copy_bench

    cell = harness.load_cell(copy_bench(tmp_path_factory.mktemp("vnet"), TINY),
                             request.param)
    faults = VNET[request.param]
    jobs = [{"seed": SEED, "seconds": 0.0, "trace": False},
            {"seed": SEED, "control": True}]
    jobs += [{"seed": SEED, "seconds": 0.0, "trace": False, "fault": f}
             for f in faults]
    return cell, dict(zip(["sound", "control", *faults],
                          train_vnet.run_jobs(cell, jobs, "cpu")))


def test_vnet_control_is_not_correct(vnet_runs):
    """On four ranks at this size SGD's updates, far under bf16's step at
    the weights, round away differently than at the cell's size, so the
    sound run is not held to the committed limits here;
    `test_kobench_reference` holds the four-rank step to the reference in
    float32."""
    cell, runs = vnet_runs
    assert not _readings_correct(cell, runs["control"])


@pytest.mark.parametrize("fault", ("half_batch", "unchanged", "no_exchange"))
def test_vnet_planted_fault_is_not_correct(vnet_runs, fault):
    cell, runs = vnet_runs
    assert not _correct(cell, runs[fault])
