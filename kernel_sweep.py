#!/usr/bin/env python3
"""Design sweeps of the port's two hand-written kernels on one NVIDIA card.

    python3 kernel_sweep.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The kernels keep their design choices as constants. For each variant in
VARIANTS the script copies `kubeoperator_tpu_torch/` into
`build/variants/<name>/`, changes the listed lines there, and times that
copy's K1 (62,464 rows) and K2 (n = 4 and 8, 16 MB shards) in a subprocess
on the same card, as `chip_smoke.py --parent` times another checkout. The
tree itself is timed first and last. Variants are only timed, not checked
(`k1_no_finish` leaves K1's output unwritten); `chip_smoke.py` checks the
tree. Prints the card's name and power limit, then one JSON object, which
also goes to chiprun_out/kernel_sweep.json.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "kubeoperator_tpu_torch"
K1_CU, K1_PY = "csrc/dma_read.cu", "ops/dma_read.py"
K2_CU, K2_PY = "csrc/ring_all_gather.cu", "ops/ring_gather.py"

# name -> [(file under the package, line as shipped, line in the variant)]
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    # K1's ring depth (shipped: 2 stages of 32 KB)
    **{f"k1_stages{n}": [(K1_CU, "constexpr int kStages = 2;",
                          f"constexpr int kStages = {n};")] for n in (3, 4, 6)},
    # blocks that sum the partials (shipped: 64)
    **{f"k1_finishers{n}": [(K1_PY, "FINISHERS = 64 ", f"FINISHERS = {n} ")]
       for n in (8, 16, 32)},
    # the stream alone: partials written, no tickets, no finish
    "k1_no_finish": [(K1_CU, "  // every partial of this block is written; "
                      "publish it and take a ticket\n",
                      "  return;  // the stream alone\n")],
    # one contiguous run of tiles a block instead of round-robin
    "k1_contiguous_runs": [(
        K1_CU,
        "  const long long first = blockIdx.x;\n"
        "  const long long step = nblocks;\n"
        "  const long long count = (tiles - blockIdx.x + nblocks - 1) / nblocks;\n",
        "  const long long first = tiles * blockIdx.x / nblocks;\n"
        "  const long long step = 1;\n"
        "  const long long count = tiles * (blockIdx.x + 1) / nblocks - first;\n")],
    # K2's piece (shipped: 2048 vectors, 32 KB)
    **{f"k2_piece{kb}kb": [(K2_PY, "PIECE_VEC = 2048 ", f"PIECE_VEC = {kb * 64} ")]
       for kb in (16, 24, 48, 64)},
    # K2's reads without the evict-first hint (shipped: `.cs`)
    "k2_reads_cg": [(K2_CU, "if (w < hi) x[u] = __ldcs(src + w);",
                     "if (w < hi) x[u] = __ldcg(src + w);")],
}


def make_variant(name: str, edits: list[tuple[str, str, str]],
                 into: Path = ROOT / "build" / "variants") -> Path:
    """A copy of the package with `edits` applied, in `into`/`name`."""
    dest = into / name
    shutil.rmtree(dest / PACKAGE, ignore_errors=True)
    shutil.copytree(ROOT / PACKAGE, dest / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        path = dest / PACKAGE / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"kernel_sweep: {name}: {old!r} is not once in {rel}")
        path.write_text(text.replace(old, new))
    return dest


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    times = {"tree": chip_smoke.time_parent(str(ROOT))}
    print(f"tree: {times['tree']}", flush=True)
    for name, edits in VARIANTS.items():
        times[name] = chip_smoke.time_parent(str(make_variant(name, edits)))
        print(f"{name}: {times[name]}", flush=True)
    times["tree_again"] = chip_smoke.time_parent(str(ROOT))
    print(f"tree_again: {times['tree_again']}", flush=True)
    result = {"card": smi, "ms": times}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_sweep.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
