"""On the card only (marker ``cuda``; run there with
``python3 -m pytest kobench/tests -m cuda``): each one-card cell at a small
size runs its window traced, and every per-layer metric it owns comes out
as a number no share of a peak puts above 100%."""

import pytest

from kobench import harness
from kobench.tests.conftest import copy_bench

SMALL = {"d_model": 512, "d_ff": 2048, "heads": 8, "b_local": 4,
         "s_local": 256, "reference_rows": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense-train", "dense-serve"])
def test_a_traced_window_reads_every_metric(cuda, tmp_path, name):
    cell = harness.load_cell(copy_bench(tmp_path, SMALL), name)
    outcome = harness.driver(cell).run(cell, 2 ** 31 + 9, 1.0, True, "cuda")
    line = harness.result(cell, outcome, True, 1.0)
    assert line["device"]["busy_s"] > 0
    for m in cell.per_layer:
        value = line["metrics"][m["name"]]["value"]
        assert value == value and value >= 0
        if m["unit"] == "%":
            assert value <= 100.0
