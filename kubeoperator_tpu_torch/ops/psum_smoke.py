"""The cluster smoke test that gates Ready (port of `ops/psum_smoke.py`).

Runs on every rank (one process per GPU): join the process group from the
env contract, check all-reduce correctness, at 2 or more ranks check exact
ring attention over the same ranks, sweep all-reduce bus bandwidth, and
emit the one-line result the adm post-hook parses:

    KO_TPU_SMOKE_RESULT {"gbps": ..., "chips": ..., "ok": true, ...}

`chips` is the world size (one card per rank). Exit code 0 only if
correctness holds and the chip count matches `KO_TPU_EXPECTED_CHIPS`;
bandwidth thresholds are enforced server-side, as in the reference. With
`KO_TPU_TRAIN_STEPS>0` the gate also runs that many training steps of the
validation net (`ops/train_smoke.py`) and folds their verdict into `ok`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.ops.collectives import (
    bench_collective,
    verify_psum_correctness,
)
from kubeoperator_tpu_torch.ops.longcontext_check import verify_ring_attention
from kubeoperator_tpu_torch.ops.train_smoke import run_train_smoke
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env


def run_smoke(
    sizes_mb: tuple[float, ...] = (1.0, 8.0, 32.0, 64.0),
    iters: int = 10,
    device: torch.device | str | None = None,
) -> dict:
    dev = initialize_from_env(device)
    chips = dist.get_world_size()
    expected = int(os.environ.get("KO_TPU_EXPECTED_CHIPS", "0"))
    mesh = flat_axis_mesh(device_type=dev.type)
    ok = verify_psum_correctness(mesh)

    # long-context path: exact ring attention over the same ranks, which
    # catches permute-ordering and mask bugs a psum cannot see
    ring_ok = True
    if chips >= 2:
        ring_ok = verify_ring_attention(flat_axis_mesh("sp", device_type=dev.type))

    best = 0.0
    table = []
    for size in sizes_mb:
        r = bench_collective("psum", size_mb=size, mesh=mesh, iters=iters)
        table.append({"size_mb": size, "busbw_gbps": round(r.busbw_gbps, 3)})
        best = max(best, r.busbw_gbps)

    result = {
        "gbps": round(best, 3),
        "chips": chips,
        "ok": bool(ok) and bool(ring_ok)
              and (expected == 0 or chips == expected),
        "correctness": bool(ok),
        "ring_attention_correct": bool(ring_ok),
        "expected_chips": expected,
        "process_index": dist.get_rank(),
        "num_processes": chips,
        "table": table,
    }

    # optional deeper gate (smoke_train_steps var -> KO_TPU_TRAIN_STEPS):
    # a few real sharded training steps of the validation net; loss must
    # be finite and descending on the actual cards
    train_steps = int(os.environ.get("KO_TPU_TRAIN_STEPS", "0"))
    if train_steps > 0:
        train = run_train_smoke(steps=train_steps, device=dev)
        result["train"] = train
        result["ok"] = bool(result["ok"]) and bool(train["ok"])
    return result


def main(device: torch.device | str | None = None) -> int:
    initialize_from_env(device)
    result = run_smoke(device=device)
    # every rank validates; only rank 0 speaks (its pod's logs are what the
    # tpu-smoke-test role collects)
    if dist.get_rank() == 0:
        print("KO_TPU_SMOKE_RESULT " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host (gloo) instead of the card")
    sys.exit(main("cpu" if parser.parse_args().cpu else None))
