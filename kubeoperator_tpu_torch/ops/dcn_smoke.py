"""Multislice smoke over real OS processes: one psum across slices and one
across the processes of a slice (port of `ops/dcn_smoke.py`).

One process per host of the (multi)slice, each started with the host env
contract (`parallel/multislice.py::host_envs`) and joined through
`initialize_from_env`, builds the ``(dcn, ici_0)`` mesh, checks that the
dcn axis falls on the slice id the contract gave it, and proves both
boundary classes in one run:

  * the slice boundary: a psum over ``dcn`` crosses slices;
  * the host boundary inside a slice: each slice spans two processes, so a
    psum over ``ici_0`` crosses processes without crossing slices.

torch puts one rank in each process, so each process holds one device
(the reference's `local_devices=1`): `v5p-16` x 2 is four processes, and
both sums are 1 + 2 = 3. Like the reference's workers, which are pure-CPU
by design, `run_dcn_smoke()` runs gloo ranks on the host;
``device="cuda"`` runs one NCCL rank per card instead and refuses with
fewer cards than processes.

    python -m kubeoperator_tpu_torch.ops.dcn_smoke [--cpu]

runs one rank per card (4 cards), or gloo ranks on the host with
``--cpu``, prints one ``KO_TPU_DCN_SMOKE_REPORT {...}`` line and exits 0
when `ok`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel.mesh import build_mesh
from kubeoperator_tpu_torch.parallel.multislice import host_envs, initialize_from_env
from kubeoperator_tpu_torch.parallel.topology import V5P_16_X2
from kubeoperator_tpu_torch.utils.device import resolve_device
from kubeoperator_tpu_torch.utils.launch import free_port_pair, run_ranks

RESULT_MARKER = "KO_TPU_DCN_SMOKE"
LOCAL_DEVICES = 1          # one rank, so one device, per process
TIMEOUT_S = 300.0


def worker() -> None:
    """One process of the smoke: bootstrap from the env contract first,
    then the mesh and the two sums; prints this rank's marker line."""
    slice_id = int(os.environ["KO_TPU_SLICE_ID"])
    num_slices = int(os.environ["KO_TPU_SMOKE_SLICES"])
    procs_per_slice = int(os.environ["KO_TPU_SMOKE_PROCS_PER_SLICE"])
    if num_slices > 1 and (
            os.environ["MEGASCALE_NUM_SLICES"] != str(num_slices)
            or int(os.environ["MEGASCALE_SLICE_ID"]) != slice_id):
        raise RuntimeError("MEGASCALE_* disagree with the slice geometry")
    dev = initialize_from_env(os.environ["KO_TPU_SMOKE_DEVICE"])
    procs = num_slices * procs_per_slice
    if dist.get_world_size() != procs:
        raise RuntimeError(f"{dist.get_world_size()} ranks, want {procs}")
    # ranks are process-major, so each slice's processes form one dcn row:
    # check it rather than assume it
    mesh = build_mesh(("dcn", "ici_0"), (num_slices, procs_per_slice * LOCAL_DEVICES))
    if mesh.get_local_rank("dcn") != slice_id:
        raise RuntimeError(f"rank {dist.get_rank()} is in dcn row "
                           f"{mesh.get_local_rank('dcn')}, its slice is {slice_id}")
    # cross-slice: slice s contributes s+1; cross-host inside the slice:
    # ici_0 position i contributes i+1
    dcn = torch.full((1,), float(slice_id + 1), device=dev)
    dist.all_reduce(dcn, group=mesh.get_group("dcn"))
    ici = torch.full((1,), float(mesh.get_local_rank("ici_0") + 1), device=dev)
    dist.all_reduce(ici, group=mesh.get_group("ici_0"))
    print(RESULT_MARKER + " " + json.dumps({
        "rank": dist.get_rank(), "slice": slice_id,
        "dcn_psum": float(dcn[0]), "ici_psum": float(ici[0]),
    }), flush=True)
    dist.barrier()
    # no teardown: gloo can abort a rank whose peer, or the host of the
    # rendezvous store (rank 0), has already gone
    os._exit(0)


def run_dcn_smoke(device: str = "cpu") -> dict:
    """Run the multislice smoke: one OS process per host of `v5p-16` x 2
    (two processes per slice), gloo ranks on the host or, with
    ``device="cuda"``, one NCCL rank per card. Returns the reference's
    report (`ok`, per-boundary psum values, wall time)."""
    topo = V5P_16_X2
    envs = host_envs(topo, "127.0.0.1", port=free_port_pair())
    if device == "cuda" and torch.cuda.device_count() < len(envs):
        raise RuntimeError(
            f"the smoke on cards runs one rank per card: {len(envs)} "
            f"processes, {torch.cuda.device_count()} cards visible")
    procs_per_slice = topo.hosts_per_slice
    expected_dcn = float(sum(range(1, topo.num_slices + 1)))
    per_slice = procs_per_slice * LOCAL_DEVICES
    expected_ici = float(sum(range(1, per_slice + 1)))
    blocks = [dict(henv.to_env(),
                   KO_TPU_SMOKE_SLICES=str(topo.num_slices),
                   KO_TPU_SMOKE_PROCS_PER_SLICE=str(procs_per_slice),
                   KO_TPU_SMOKE_DEVICE=device,
                   # a rank sums one float: one compute thread is plenty
                   OMP_NUM_THREADS="1")
              for henv in envs]
    t0 = time.monotonic()
    ran = run_ranks("from kubeoperator_tpu_torch.ops.dcn_smoke import worker; "
                    "worker()", blocks, TIMEOUT_S)
    wall_s = time.monotonic() - t0
    results, errors = [], []
    for rc, out, err in ran:
        if rc != 0:
            errors.append(err[-2000:])
            continue
        for line in out.splitlines():
            if line.startswith(RESULT_MARKER + " "):
                results.append(json.loads(line[len(RESULT_MARKER):]))
    ok = (
        not errors
        and len(results) == len(envs)
        and all(r["dcn_psum"] == expected_dcn for r in results)
        and all(r["ici_psum"] == expected_ici for r in results)
    )
    return {
        "ok": ok,
        "tpu_type": topo.accelerator_type,
        "num_slices": topo.num_slices,
        "processes": len(envs),
        "procs_per_slice": procs_per_slice,
        "local_devices": LOCAL_DEVICES,
        "global_devices": len(envs) * LOCAL_DEVICES,
        "dcn_psum": sorted({r["dcn_psum"] for r in results}),
        "ici_psum": sorted({r["ici_psum"] for r in results}),
        "expected_dcn_psum": expected_dcn,
        "expected_ici_psum": expected_ici,
        "errors": errors,
        "wall_s": round(wall_s, 3),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run gloo ranks on the host, not one rank per card")
    args = parser.parse_args(argv)
    report = run_dcn_smoke("cpu" if args.cpu else resolve_device().type)
    print(RESULT_MARKER + "_REPORT " + json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
