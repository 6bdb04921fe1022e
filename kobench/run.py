"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m kobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (process start, weights and inputs
made on the device from the seed, the cell's own shapes warmed up) is
timed as ``setup_s``; then the window runs for ``--seconds``; then the
program's outputs are held against the plain reference. The last lines of
standard error are the compared numbers beside their limits; the last
line of standard output is the JSON result. Exits non-zero, printing no
result, without enough CUDA cards, or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_start() -> float:
    """Wall time this process started, from /proc; the module's import
    time where /proc is absent."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return min(time.time() - age, PROCESS_T0)
    except (OSError, ValueError, IndexError):
        return PROCESS_T0


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout, and
    libraries kept from loading JAX."""
    cache = root / "build" / "kobench-cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
            "CUDA_CACHE_PATH": str(cache / "nv"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def finite(obj):
    """`obj` with every non-finite float as None (JSON has no infinity)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    os.environ.update(cache_env(root))

    from kobench import harness

    cell = harness.load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kobench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"{have} visible", file=sys.stderr)
        return 2
    t0 = process_start()
    outcome = harness.driver(cell).run(cell, seed=args.seed,
                                       seconds=args.seconds,
                                       trace=bool(args.trace), device="cuda")
    import torch.distributed as dist

    if dist.is_initialized():          # the one-card drivers' own group
        dist.destroy_process_group()
    found = harness.forbidden_loaded() + outcome.get("forbidden", [])
    if found:
        print(f"kobench: JAX or the JAX package was loaded: {sorted(set(found))}",
              file=sys.stderr)
        return 3
    line = harness.result(cell, outcome, bool(args.trace),
                          outcome["window_start"] - t0)
    for name, value in outcome["readings"].items():
        print(f"kobench: reading {name} = {value!r}", file=sys.stderr)
    if args.trace:
        print(f"kobench: card {power_limit()}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"kobench: check {name} = {check['value']!r} limit "
              f"{check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
