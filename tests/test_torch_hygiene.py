"""Import hygiene of the port: it never imports JAX, `optax`, `ml_dtypes`
(which the card's machine lacks) or the JAX package, and its kernel sources
(K1, K2) are built for sm_90a."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kubeoperator_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kubeoperator_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "kernel_sweep.py"]


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "ml_dtypes",
                           "kubeoperator_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, kubeoperator_tpu_torch, kubeoperator_tpu_torch.ops, "
            "kubeoperator_tpu_torch.cli.koctl, kubeoperator_tpu_torch.weights, "
            "kubeoperator_tpu_torch.ops.psum_smoke, "
            "kubeoperator_tpu_torch.parallel.validation_net, "
            "kubeoperator_tpu_torch.workloads.harness, "
            "kubeoperator_tpu_torch.workloads.checkpoint, "
            "kubeoperator_tpu_torch.workloads.serve, "
            "kubeoperator_tpu_torch.bench, kubeoperator_tpu_torch.graft_entry, "
            "kubeoperator_tpu_torch.ops.dcn_smoke, "
            "kubeoperator_tpu_torch.service.drills, "
            "kubeoperator_tpu_torch.perf_rows, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'ml_dtypes', 'kubeoperator_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_source_exists_and_builds_for_sm_90a():
    assert (ROOT / "kubeoperator_tpu_torch" / "csrc" / "dma_read.cu").is_file()
    assert "dma_read" in _build.kernel_names()
    cmd = _build.nvcc_command(Path("dma_read.cu"), Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3"} <= set(cmd)
    # named by content: the build lands in build/kernels/, which git ignores
    lib = _build.library_path("dma_read")
    assert lib.parent == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_ring_kernel_source_exists_and_builds_for_sm_90a():
    src = ROOT / "kubeoperator_tpu_torch" / "csrc" / "ring_all_gather.cu"
    assert src.is_file()
    assert _build.kernel_names() == ["dma_read", "ring_all_gather"]
    cmd = _build.nvcc_command(src, Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    assert _build.library_path("ring_all_gather").parent == ROOT / "build" / "kernels"
    text = src.read_text()
    # co-resident by cooperative launch, bounded waits, system-scope flags
    for needle in ("cudaLaunchCooperativeKernel", "%%globaltimer",
                   "ld.acquire.sys", "st.release.sys"):
        assert needle in text, needle
