"""The reference's two chaos soaks whose full mesh is data=2,fsdp=4, driven
through the port's device seams on the host: the preemption drill's notice
scenario (`kubeoperator_tpu/cli/koctl.py::_notice_soak_once`) and the
serving drill (`_serve_soak_once`). Helpers, passes and tolerances are
`tests/test_torch_soaks.py`'s.

These are the suite's only 8-rank relayed runs (the 4-rank rule's exception,
ROADMAP): the reference's own tier-1 runs the notice drill on 8 virtual
devices (`tests/test_slicepool.py::TestPreemptionDrill`). Through the port
they cover what no smaller run does:

* notice: the 6-step run on 8 gloo ranks is drained at step 2 into a
  checkpoint gathered from 8 ranks; the slice pool's degrade leg restores
  it on data=1,fsdp=4 (4 ranks) and `train --resume` finishes it on 8;
* serve: the server answers on 8 ranks and re-shards onto 4 through the
  relay (ranks 4-7 leave early, rank 0's record is the run's) while tina's
  4-rank lane runs beside it (``queue.max_concurrent`` 2): up to 12 rank
  processes at once.

The one-spawn lock is held once around each port pass: both lanes of the
serve soak relay from threads of this process, so a lock taken per run
would block the second lane against the first.
"""

import pytest

from tests.test_torch_soaks import (
    assert_all_checks_pass,
    assert_same_runs,
    assert_same_structure,
    both_passes,
    ranks_of,
)


@pytest.fixture(scope="module")
def notice(tmp_path_factory):
    return both_passes(tmp_path_factory, "notice")


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    return both_passes(tmp_path_factory, "serve")


@pytest.fixture(params=["notice", "serve"])
def soak(request):
    return request.getfixturevalue(request.param)


def test_every_check_passes_in_both_passes(soak):
    assert_all_checks_pass(soak)


def test_structures_match_key_by_key(soak):
    assert_same_structure(soak["port"]["structure"], soak["jax"]["structure"])


def test_every_device_run_matches_the_pure_jax_run(soak):
    assert_same_runs(soak)
    assert max(ranks_of(r["mesh"]) for r in soak["port"]["runs"]) == 8


def test_notice_degrade_leg_resumed_the_8_rank_checkpoint_on_4(notice):
    # reference run, drained run, degrade leg, full-mesh resume, in order;
    # the degrade leg's losses are compared with pure JAX's by
    # `assert_same_runs`, here its place in the story
    runs = [(r["mesh"], r["start_step"], r["end_step"])
            for r in notice["port"]["runs"]]
    assert runs == [("data=2,fsdp=4,tp=1", 0, 6), ("data=2,fsdp=4,tp=1", 0, 2),
                    ("data=1,fsdp=4,tp=1", 2, 6), ("data=2,fsdp=4,tp=1", 2, 6)]
    structure = notice["port"]["structure"]
    assert structure["losses"] == structure["reference"]
    assert structure["checkpoint_step"] == 2


def test_serve_resharded_8_ranks_onto_4_beside_a_second_lane(serve):
    served = [r for r in serve["port"]["runs"] if r["kind"] == "serve"]
    # the undegraded reference, then the server that lost a slice
    assert [(r["mesh"], r["degraded"]) for r in served] \
        == [("data=2,fsdp=4,tp=1", False), ("data=2,fsdp=4,tp=1", True)]
    reference, server = served
    assert server["values"][:2] == reference["values"][:2]
    structure = serve["port"]["structure"]
    assert structure["degraded_mesh"] == {"data": 1, "fsdp": 4, "tp": 1}
    assert structure["concurrent"] is True
