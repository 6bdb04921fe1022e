"""`kubeoperator_tpu_torch/perf_rows.py` against the device rows of
`perf_matrix.py` (`run_workloads`, `run_checkpoint`, `run_multislice`), on
the host: the same keys, a checkpoint round trip that is exact at world 1
and on 2 gloo ranks, and the DCN row of `v5p-16` x 2 equal to the
reference's at one device a process (the port's shape: one rank a
process). `main` prints the three and writes neither PERF.json nor PERF.md;
without ``--cpu`` it sends every row to the cards, the DCN row first.
"""

import hashlib
import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch

import perf_matrix
from kubeoperator_tpu.ops import dcn_smoke as jax_dcn
from kubeoperator_tpu_torch import perf_rows

from tests.test_torch_ops import one_spawn_at_a_time
from tests.test_torch_service import use_devices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference_checkpoint():
    return perf_matrix.run_checkpoint()


def test_workload_rows_have_the_reference_keys(monkeypatch):
    use_devices(monkeypatch, 2)
    want = perf_matrix.run_workloads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with one_spawn_at_a_time():
        got = perf_rows.run_workloads(device="cpu", ranks=2)
    assert sorted(got) == sorted(want) and got["ok"] and got["devices"] == 2
    assert [sorted(r) for r in got["rows"]] == [sorted(r) for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["axis"], g["devices"], g["mesh"], g["mode"]) \
            == (w["axis"], w["devices"], w["mesh"], w["mode"])


@pytest.mark.parametrize("ranks", [1, 2])
def test_checkpoint_round_trip_is_exact(reference_checkpoint, monkeypatch, ranks):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with one_spawn_at_a_time():
        got = perf_rows.run_checkpoint(device="cpu", ranks=ranks)
    want = reference_checkpoint
    assert sorted(got) == sorted(want) and got["ok"]
    (row,), (ref,) = got["rows"], want["rows"]
    assert sorted(row) == sorted(ref)
    assert row["round_trip_exact"] is True and ref["round_trip_exact"] is True
    # the same gathered TrainState, whatever mesh trained it
    assert (row["leaves"], row["mbytes"]) == (ref["leaves"], ref["mbytes"])


def test_dcn_row_equals_the_reference_at_one_device_a_process(monkeypatch):
    real = jax_dcn.run_dcn_smoke
    monkeypatch.setattr(jax_dcn, "run_dcn_smoke",
                        lambda **kw: real(**dict(kw, local_devices=1)))
    with one_spawn_at_a_time():
        want = perf_matrix.run_multislice()
        got = perf_rows.run_multislice()
    assert got["ok"] and want["ok"] and got["device"] == "cpu"
    (row,), (ref,) = got["rows"], want["rows"]
    assert sorted(row) == sorted(ref)
    assert {k: v for k, v in row.items() if k != "wall_s"} \
        == {k: v for k, v in ref.items() if k != "wall_s"}


def test_main_prints_the_rows_and_writes_nothing(monkeypatch):
    def digest(name):
        with open(os.path.join(ROOT, name), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = {name: digest(name) for name in ("PERF.json", "PERF.md")}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = io.StringIO()
    with one_spawn_at_a_time(), redirect_stdout(out):
        rc = perf_rows.main(["--cpu"])
    assert rc == 0
    printed = json.loads(out.getvalue())
    assert sorted(printed) == ["checkpoint", "kernel_launches", "multislice",
                               "workloads"]
    assert printed["workloads"]["devices"] == 1
    assert printed["multislice"]["device"] == "cpu"
    assert set(printed["kernel_launches"]) == {"dma_read", "ring_all_gather"}
    assert printed["checkpoint"]["rows"][0]["round_trip_exact"] is True
    assert {name: digest(name) for name in before} == before


def _record_rows(monkeypatch) -> list:
    """Replace the three rows by stubs that log (row, device)."""
    calls = []
    for row in ("multislice", "workloads", "checkpoint"):
        monkeypatch.setattr(perf_rows, f"run_{row}", lambda device, _row=row:
                            calls.append((_row, device)) or {"ok": True})
    return calls


def test_main_runs_every_row_on_the_cards_unless_asked(monkeypatch):
    # without --cpu the DCN row goes to the cards too (one NCCL rank a card),
    # never to 4 gloo processes on the host; it runs first, so on fewer
    # than 4 cards the refusal comes before the long rows
    calls = _record_rows(monkeypatch)
    monkeypatch.setattr(perf_rows, "resolve_device", lambda device=None:
                        torch.device(device or "cuda"))
    with redirect_stdout(io.StringIO()):
        assert perf_rows.main([]) == 0
        assert perf_rows.main(["--cpu"]) == 0
    assert calls == [("multislice", "cuda"), ("workloads", None),
                     ("checkpoint", None), ("multislice", "cpu"),
                     ("workloads", "cpu"), ("checkpoint", "cpu")]


def test_main_without_a_card_refuses_before_any_row(monkeypatch):
    calls = _record_rows(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        perf_rows.main([])
    assert calls == []

