"""Training smoke: a few real sharded training steps as a node health
workload (port of `ops/train_smoke.py`).

The psum smoke proves the interconnect moves bytes; this proves the whole
training loop — tensor-core matmuls, ring-attention exchanges, MoE
all-to-all, pipeline ppermute, backward pass, remat, SGD update — runs on
the actual cards, using the validation net (`parallel/validation_net.py`).
Pass criteria: every loss finite, and the loss after the last step below
the first (a small net on a fixed batch must descend; a sick card or a
miswired link diverges, gives NaNs, or hangs).

Emits the same one-line machine contract as the reference:

    KO_TPU_TRAIN_RESULT {"ok": true, "losses": [...], "steps_per_s": ...}
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel import validation_net as vnet
from kubeoperator_tpu_torch.parallel.mesh import mesh_sizes
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env


def run_train_smoke(
    steps: int = 4,
    device: torch.device | str | None = None,
    peak_tflops_per_chip: float | None = None,
    cfg: vnet.NetConfig | None = None,
) -> dict:
    """`steps` training steps of the validation net over every rank of the
    process group (one mesh axis per parallelism family, `axis_sizes`)."""
    dev = initialize_from_env(device)
    cfg = cfg or vnet.NetConfig()
    mesh = vnet.build_mesh_for(device_type=dev.type)
    params, x, _ = vnet.build_params_and_batch(mesh, cfg=cfg)
    train_step = vnet.make_train_step(mesh, cfg=cfg)

    # the first step runs outside the timed window; it is step 1 of `steps`
    loss, params = train_step(params, x)
    device_losses = [loss]
    float(loss)                           # warm-up fence
    float(params["w_head"][0, 0])
    t0 = time.perf_counter()
    for _ in range(max(steps - 1, 0)):
        loss, params = train_step(params, x)
        device_losses.append(loss)
    # fence once at the end on a value that depends on the LAST step's
    # parameter update (not just its loss, which only proves the forward
    # pass ran): steps queue asynchronously on the card, and a scalar read
    # cannot complete before the work it depends on has
    float(params["w_head"][0, 0])
    dt = time.perf_counter() - t0
    losses = [float(l) for l in device_losses]

    finite = all(math.isfinite(l) for l in losses)
    # a single-step run has no loss pair to compare — finiteness is the gate
    descending = losses[-1] < losses[0] if len(losses) > 1 else True
    ok = finite and descending
    steps_per_s = round((len(losses) - 1) / dt, 3) if dt > 0 else 0.0
    # steps/s is config-relative; converted to achieved model TFLOP/s (and
    # MFU when the caller supplies the card's data-sheet peak)
    step_flops = vnet.analytic_train_flops(mesh, cfg)
    tflops_per_s = round(steps_per_s * step_flops / 1e12, 4)
    n_devices = dist.get_world_size()
    result = {
        "ok": ok,
        "finite": finite,
        "descending": descending,
        "losses": [round(l, 6) for l in losses],
        "steps_per_s": steps_per_s,
        "model_tflops_per_s": tflops_per_s,
        "devices": n_devices,
        "mesh": mesh_sizes(mesh),
    }
    if peak_tflops_per_chip:
        peak = peak_tflops_per_chip * n_devices
        result["mfu_pct"] = round(100.0 * tflops_per_s / peak, 3)
    return result


def main(device: torch.device | str | None = None) -> int:
    """Job entry point (mirrors psum_smoke.main): join the process group
    from the env contract, run, emit the marker line."""
    initialize_from_env(device)
    result = run_train_smoke(device=device)
    print("KO_TPU_TRAIN_RESULT " + json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host (gloo) instead of the card")
    sys.exit(main("cpu" if parser.parse_args().cpu else None))
