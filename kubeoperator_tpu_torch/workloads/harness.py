"""Scaling-efficiency harness: sweep mesh shapes over the process group's
ranks, report per-axis scaling efficiency, step time, and MFU (port of
`workloads/harness.py`).

For each workload axis (data, fsdp, tp) the harness runs the SAME train
step on meshes that grow only that axis and compares achieved model
TFLOP/s against perfect linear scaling from the 1-rank baseline:

    efficiency(axis, n) = achieved_tflops(n) / (n · achieved_tflops(1))

data/fsdp weak-scale the batch while tp strong-scales the FFN; achieved
FLOP throughput makes them comparable. MFU rides alongside when the caller
supplies the card's data-sheet peak, with the NVLink envelope quoted for
context.

Emits the reference's one-line machine contract:

    KO_TPU_WORKLOAD_RESULT {"ok": true, "rows": [...], ...}

Timing discipline matches ops/train_smoke.py: the first step outside the
timed window, steps queued asynchronously, ONE scalar read that depends on
the last parameter update as the end fence.

    python -m kubeoperator_tpu_torch.workloads.harness [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.parallel.mesh import (
    MeshSpec,
    format_axes,
    in_mesh,
    mesh_sizes,
)
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.utils.spans import span
from kubeoperator_tpu_torch.workloads.mla_moe import MlaMoeConfig
from kubeoperator_tpu_torch.workloads.partition import (
    make_shard_and_gather_fns,
    replicated_specs,
)
from kubeoperator_tpu_torch.workloads.step import (
    WORKLOAD_AXES,
    analytic_step_flops,
    build_batch,
    init_train_state,
    make_train_step,
)

# per-run row keys the platform promises (docs/workloads.md "Harness
# metrics schema")
ROW_SCHEMA = ("axis", "devices", "mesh", "mode", "steps", "steps_per_s",
              "model_tflops_per_s", "scaling_efficiency_pct", "losses",
              "ok")


def run_training(mesh: DeviceMesh, cfg: NetConfig | MlaMoeConfig | None = None,
                 steps: int = 4, mode: str = "auto", rules=None, seed: int = 0,
                 state=None, on_step=None, return_state: bool = False,
                 checkpoint_every: int = 0, on_checkpoint=None) -> dict:
    """One training run on one mesh: step, fence, judge. Every rank of the
    mesh calls it together. `cfg` picks the model: the dense stage
    (`NetConfig`) or the Kimi-K2 block (`MlaMoeConfig`).

    Returns the per-run record including ``windows`` — named (compile /
    steps) wall-clock windows (the first step stands in for the reference's
    compile).

    * ``state`` — a HOST TrainState ``{"params", "opt"}`` (a restored
      checkpoint) to continue from, re-placed per the step's layout; the
      batch is still built from ``seed``, so a resumed run walks the
      trajectory the uninterrupted run would have.
    * ``on_step(completed, loss)`` — after every step; a truthy return stops
      the run at this step boundary.
    * ``return_state`` — the final TrainState (this rank's blocks) rides
      back under ``"state"``.
    * ``checkpoint_every`` / ``on_checkpoint(completed, state)`` — every N
      completed steps, inside the timed window, never on the final step.

    ``start_step``/``end_step`` come from the state's own step counter."""
    cfg = cfg or NetConfig()
    t_open = time.time()
    step_fn, specs, used = make_train_step(mesh, cfg, rules=rules, mode=mode)
    if state is None:
        state = init_train_state(mesh, cfg, seed=seed, specs=specs)
    else:
        # re-place a restored host TrainState per the step's layout
        # (replicated for shard_map): what lets a checkpoint saved on one
        # mesh continue on another
        shard_fn, _ = make_shard_and_gather_fns(
            mesh, specs if specs is not None else replicated_specs(state))
        state = shard_fn(state)
    start_step = int(float(state["params"]["step"]))
    x = build_batch(mesh, cfg, seed=seed + 1)
    # the first step runs outside the timed window; it is step 1 of `steps`
    with span("train.step"):
        loss, state = step_fn(state, x)
    device_losses = [loss]
    float(loss)
    float(state["params"]["step"])
    t_compiled = time.time()

    def periodic(completed: int) -> None:
        # after the drain check, never on the final step (the end-of-run
        # save covers it)
        if on_checkpoint and checkpoint_every > 0 and completed < steps \
                and completed % checkpoint_every == 0:
            on_checkpoint(completed, state)

    stopped = bool(on_step and on_step(1, loss))
    t0 = time.perf_counter()
    if not stopped:
        periodic(1)   # inside the timed window, like every later save
        for _ in range(max(steps - 1, 0)):
            with span("train.step"):
                loss, state = step_fn(state, x)
            device_losses.append(loss)
            if on_step and on_step(len(device_losses), loss):
                stopped = True
                break
            periodic(len(device_losses))
    # the end fence: the step counter is written last in a step, so its
    # read waits for the LAST update
    end_step = int(float(state["params"]["step"]))
    dt = time.perf_counter() - t0
    t_done = time.time()

    losses = [float(l) for l in device_losses]
    finite = all(l == l and abs(l) != float("inf") for l in losses)
    descending = losses[-1] < losses[0] if len(losses) > 1 else True
    steps_per_s = round((len(losses) - 1) / dt, 3) if dt > 0 else 0.0
    tflops = round(steps_per_s * analytic_step_flops(mesh, cfg) / 1e12, 4)
    mesh_shape = mesh_sizes(mesh)
    record = {
        "ok": finite and descending,
        "finite": finite,
        "descending": descending,
        "losses": [round(l, 6) for l in losses],
        "steps": len(losses),
        "start_step": start_step,
        "end_step": end_step,
        "stopped_early": stopped,
        "steps_per_s": steps_per_s,
        "model_tflops_per_s": tflops,
        "mode": used,
        "devices": mesh.size(),
        "mesh": mesh_shape,
        "windows": [
            {"name": "compile", "start": t_open, "end": t_compiled,
             "attrs": {"mode": used, "mesh": format_axes(mesh_shape)}},
            {"name": "steps", "start": t_compiled, "end": t_done,
             "attrs": {"steps": len(losses),
                       "steps_per_s": steps_per_s}},
        ],
    }
    if return_state:
        record["state"] = state
    return record


def sweep_specs(n_devices: int, axes=WORKLOAD_AXES) -> list[MeshSpec]:
    """The sweep plan: the 1-rank baseline, then each axis in `axes` grown
    alone through the powers of two up to `n_devices` (other axes 1). Every
    spec carries ALL workload axes; `axes` only picks which get grown."""
    base = {name: 1 for name in WORKLOAD_AXES}
    specs = [MeshSpec(axes=tuple(base.items()))]
    for axis in axes:
        n = 2
        while n <= n_devices:
            shape = dict(base)
            shape[axis] = n
            specs.append(MeshSpec(axes=tuple(shape.items())))
            n *= 2
    return specs


def run_sweep(devices=None, cfg: NetConfig | None = None, steps: int = 4,
              mode: str = "auto", peak_tflops_per_chip: float | None = None,
              ici_envelope_gbps: float | None = None,
              axes=WORKLOAD_AXES) -> dict:
    """The scaling sweep (module docstring) over `devices`, a list of ranks
    of the default group (default: all of them): a mesh of k ranks runs on
    the first k. Every rank of the default group calls this; ranks outside
    a mesh sit its run out, and every rank returns the same report."""
    cfg = cfg or NetConfig()
    ranks = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    n = len(ranks)
    rows: list[dict] = []
    baseline_tflops = None
    ok = True
    for spec in sweep_specs(n, axes):
        if spec.total_devices > n:
            continue
        mesh = spec.build(ranks=ranks[: spec.total_devices])
        run = run_training(mesh, cfg, steps=steps, mode=mode) \
            if in_mesh(mesh) else None
        box = [run]
        dist.broadcast_object_list(box, src=ranks[0])   # a member of every mesh
        run = box[0]
        grown = [a for a, s in spec.axes if s > 1]
        row = {
            "axis": grown[0] if grown else "baseline",
            "devices": run["devices"],
            "mesh": run["mesh"],
            "mode": run["mode"],
            "steps": run["steps"],
            "steps_per_s": run["steps_per_s"],
            "model_tflops_per_s": run["model_tflops_per_s"],
            "losses": run["losses"],
            "ok": run["ok"],
        }
        if baseline_tflops is None:
            baseline_tflops = run["model_tflops_per_s"]
            row["scaling_efficiency_pct"] = 100.0
        else:
            ideal = baseline_tflops * run["devices"]
            row["scaling_efficiency_pct"] = round(
                100.0 * run["model_tflops_per_s"] / ideal, 1) \
                if ideal > 0 else 0.0
        if peak_tflops_per_chip:
            row["mfu_pct"] = round(
                100.0 * run["model_tflops_per_s"]
                / (peak_tflops_per_chip * run["devices"]), 3)
        ok = ok and run["ok"]
        rows.append(row)
    report = {
        "ok": ok,
        "devices": n,
        "axes": list(axes),
        "baseline": rows[0] if rows else None,
        "rows": rows,
        "config": {
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "heads": cfg.heads,
            "b_local": cfg.b_local, "s_local": cfg.s_local,
            "dtype": cfg.dtype, "steps": steps,
        },
    }
    if peak_tflops_per_chip:
        report["peak_tflops_per_chip"] = peak_tflops_per_chip
    if ici_envelope_gbps:
        # context for reading the efficiency columns on hardware: the
        # per-axis gap to 100% is collective traffic on this envelope
        report["ici_envelope_gbps"] = ici_envelope_gbps
    return report


def main(argv: list[str] | None = None) -> int:
    """Job entry point (mirrors train_smoke.main): join the process group
    from the env contract, sweep, emit the marker line."""
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.parallel.topology import generation_for_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host (gloo) instead of the card")
    args = parser.parse_args(argv)
    dev = initialize_from_env("cpu" if args.cpu else None)
    gen = generation_for_device(dev)
    report = run_sweep(
        peak_tflops_per_chip=gen.bf16_tflops_per_chip if gen else None,
        ici_envelope_gbps=gen.nvlink_gbps_per_gpu if gen else None,
    )
    print("KO_TPU_WORKLOAD_RESULT " + json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
