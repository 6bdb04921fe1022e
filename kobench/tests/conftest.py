"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
with every configuration cut to a size the CPU runs in seconds, and the
``cuda`` marker for the tests that need a card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"d_model": 64, "d_ff": 128, "heads": 4, "b_local": 4, "s_local": 16,
        "reference_rows": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def copy_bench(dest: Path, dims: dict | None = None) -> Path:
    """BENCHMARK.json and kobench/'s data files under `dest`, each
    configuration's dims replaced by `dims` (none: as they are)."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "kobench" / sub, dest / "kobench" / sub)
    if dims:
        for path in (dest / "kobench" / "configs").glob("*.json"):
            cfg = json.loads(path.read_text())
            cfg.update(dims)
            path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return copy_bench(tmp_path, TINY)


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch
