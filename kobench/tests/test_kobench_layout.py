"""The benchmark's layout: BENCHMARK.json meets its contract's shape, every
piece is found by name, a new cell and a new metric are picked up from new
files alone, and nothing imports JAX, optax or the JAX package (the
references nothing of the port either), names compared whole."""

import ast
import json
import re
from pathlib import Path

import pytest

from kobench import harness
from kobench.tests.conftest import REPO, copy_bench

KOBENCH = REPO / "kobench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
FILES = sorted(KOBENCH.rglob("*.py"))


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_optax_or_jax_package(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "optax", "kubeoperator_tpu"}
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", sorted((KOBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "kubeoperator_tpu_torch" not in _imports(path)


def test_the_port_is_imported_only_by_drivers_and_faults():
    users = {p.relative_to(KOBENCH).as_posix() for p in FILES
             if "kubeoperator_tpu_torch" in _imports(p)}
    assert {u for u in users if not u.startswith("tests/")} <= {
        "drivers/train_dense.py", "drivers/train_vnet.py",
        "drivers/serve_dense.py", "faults.py"}, users


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("kobench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = harness.load_cell(REPO, cell)
    assert harness.driver(c).run
    assert c.traffic["limits"]
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(REPO, m["name"]))
    assert (KOBENCH / "reference" / f"{c.config['reference']}.py").is_file()


def test_a_new_cell_and_metric_come_from_new_files_alone(tmp_path):
    """A dummy metric file and a dummy cell (a traffic file and entries in
    BENCHMARK.json) are picked up; no existing file of kobench/ changes."""
    from kobench.tests.conftest import TINY

    root = copy_bench(tmp_path, TINY)
    before = {p: p.read_bytes() for p in (root / "kobench").rglob("*")
              if p.is_file()}
    (root / "kobench" / "metrics" / "dummy_steps.py").write_text(
        "def read(layer):\n    return float(layer['steps'])\n")
    traffic = json.loads((root / "kobench/traffic/dense-train.json").read_text())
    (root / "kobench/traffic/dummy-cell.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-cell", "config": "dense-stage-bench",
                               "traffic": "dummy-cell", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "train_tokens_per_s",
                               "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(root, "dummy-cell")
    outcome = harness.driver(cell).run(cell, seed=2 ** 31 + 3, seconds=0.2,
                                       trace=True, device="cpu")
    line = harness.result(cell, outcome, True, 1.0)
    assert line["metrics"]["dummy_steps"]["value"] == outcome["layer"]["steps"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())
