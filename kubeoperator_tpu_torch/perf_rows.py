"""The device rows of `perf_matrix.py` on the port: the workload scaling
sweep (`run_workloads`), one TrainState's checkpoint round trip
(`run_checkpoint`) and the multislice DCN smoke (`run_multislice`), each
returning the reference function's payload (``{"ok", ..., "rows": [...]}``)
with the reference's row keys.

    python -m kubeoperator_tpu_torch.perf_rows [--cpu]

runs the three on the visible cards (the DCN row takes one card a rank, so
4 cards; with fewer it refuses before any row runs) or, with ``--cpu``, on
the host (one rank; the DCN row on 4 gloo processes; the functions take a
count of host ranks, which run through the callback relay), and prints them
as one JSON object with the launches of the hand-written kernels in this
process (the rows run neither). It writes nothing: `PERF.json` is the reference's record of TPU and host
rounds, and `perf_matrix.py`'s renderer rewrites `PERF.md` whole from it.

The differences from the reference's rows, each the port's shape of the same
work:

* `run_workloads` sweeps the ranks it is given, where the reference sweeps
  the 8 virtual CPU devices of tier-1;
* `run_checkpoint` trains 2 steps on every rank on the data axis (the
  reference: data=2,fsdp=4 over 8 devices) and saves, verifies and restores
  the gathered TrainState, which is the same tree whatever the mesh;
* `run_multislice` runs the DCN smoke of `ops/dcn_smoke.py` (`v5p-16` x 2,
  one rank and so one device a process: 4 gloo processes on the host, as
  the reference's workers are pure-CPU, or with ``device="cuda"`` one NCCL
  rank a card); the reference's row holds 2 devices a process.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from kubeoperator_tpu_torch.ops.dcn_smoke import run_dcn_smoke
from kubeoperator_tpu_torch.ops.dma_read import dma_read
from kubeoperator_tpu_torch.ops.ring_gather import ring_all_gather
from kubeoperator_tpu_torch.parallel.mesh import format_axes
from kubeoperator_tpu_torch.service import workload as sw
from kubeoperator_tpu_torch.utils.device import resolve_device
from kubeoperator_tpu_torch.workloads.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from kubeoperator_tpu_torch.workloads.partition import tree_paths
from kubeoperator_tpu_torch.workloads.step import train_state_shapes

WORKLOAD_KEYS = ("axis", "devices", "mode", "steps_per_s",
                 "model_tflops_per_s", "scaling_efficiency_pct")
DCN_KEYS = ("tpu_type", "num_slices", "processes", "procs_per_slice",
            "global_devices", "expected_dcn_psum", "expected_ici_psum", "ok",
            "wall_s")


def run_workloads(device=None, ranks: int | None = None) -> dict:
    """The scaling sweep, 4 steps a mesh, over the visible cards (or `ranks`
    host ranks)."""
    visible = sw.visible_devices(device, ranks)
    report = sw.run_sweep(devices=visible, steps=4, device=device)
    rows = []
    for r in report["rows"]:
        row = {k: r[k] for k in WORKLOAD_KEYS if k in r}
        row["mesh"] = format_axes(r["mesh"])
        rows.append(row)
    return {"ok": report["ok"], "devices": report["devices"], "rows": rows}


def run_checkpoint(device=None, ranks: int | None = None) -> dict:
    """Save, hash-verify and restore the TrainState of a 2-step run; the
    round trip must give back every leaf bit for bit."""
    visible = sw.visible_devices(device, ranks)
    run = sw.run_training(sw.workload_spec("", len(visible)), steps=2,
                          mode="auto", seed=0, return_state=True,
                          device=device, visible=visible)
    host = run.pop("state")
    with tempfile.TemporaryDirectory(prefix="ko-ckpt-perf-") as root:
        t0 = time.perf_counter()
        manifest = save_checkpoint(root, host, step=2, target_steps=2,
                                   mesh=run["mesh"], seed=0)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify_checkpoint(manifest["dir"])
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = restore_checkpoint(manifest["dir"], train_state_shapes())
        restore_s = time.perf_counter() - t0
    exact = all(pa == pb and np.array_equal(a, b) for (pa, a), (pb, b)
                in zip(tree_paths(host), tree_paths(back)))
    mb = manifest["total_bytes"] / 1e6
    row = {
        "leaves": len(manifest["leaves"]),
        "mbytes": round(mb, 3),
        "save_s": round(save_s, 4),
        "save_mb_s": round(mb / save_s, 1) if save_s > 0 else 0.0,
        "verify_s": round(verify_s, 4),
        "restore_s": round(restore_s, 4),
        "restore_mb_s": round(mb / restore_s, 1) if restore_s > 0 else 0.0,
        "round_trip_exact": exact,
    }
    return {"ok": exact, "rows": [row]}


def run_multislice(device: str = "cpu") -> dict:
    """The DCN smoke's row (module docstring)."""
    report = run_dcn_smoke(device)
    row = {k: report[k] for k in DCN_KEYS}
    # psum sets render as their single expected value when clean
    for key in ("dcn_psum", "ici_psum"):
        row[key] = (report[key][0] if len(report[key]) == 1
                    else str(report[key]))
    return {"ok": report["ok"], "rows": [row], "device": device}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host (one rank) instead of the cards")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    # the DCN row first: on the cards it refuses before the long rows run
    multislice = run_multislice(resolve_device(device).type)
    rows = {"workloads": run_workloads(device),
            "checkpoint": run_checkpoint(device), "multislice": multislice}
    print(json.dumps({**rows, "kernel_launches": {
        "dma_read": dma_read.launches,
        "ring_all_gather": ring_all_gather.launches}}, indent=2))
    return 0 if all(part["ok"] for part in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
