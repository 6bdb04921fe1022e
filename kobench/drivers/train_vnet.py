"""The training window of the validation net's sharded step,
`kubeoperator_tpu_torch/parallel/validation_net.py::make_train_step`, on
the (dp, pp, sp, tp) mesh of `build_mesh_for`: one process per card,
started through the port's env contract (`kobench.spawn`).

Each rank makes the global weights and batch on its card from the seed
and keeps its own shards. The step that the window drives also runs the
first `checked` steps in set-up; each rank copies its shards of the
parameters after step 1 and after the last checked step to the host, so
its card holds only the program's own state. Rank 0's host clock bounds the window: it
tells every rank after each step, over a host-side group, whether the
deadline has passed, so all ranks run the same steps. The window closes
on a read of a value that the last update wrote, on every rank.

Afterwards the copied parameters are gathered whole onto rank 0, every
rank frees its state, and rank 0 runs the plain reference of the same
global step on its card.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from kobench import compare, faults, flops, harness, inputs, peaks, spawn
from kobench import trace as tracing
from kobench.drivers.train_dense import (_net_config, _profiler, _reference,
                                         _sync, _to_host)
from kobench.reference import precision

RANK_TIMEOUT_S = 1500


def _inputs(cell, seed: int, device):
    """The global weights and batch of `seed` on `device`."""
    cfg_d = cell.config
    ref = _reference(cell)
    gen = inputs.generator(seed, device)
    dtype = inputs.DTYPES[cfg_d["dtype"]]
    p0 = inputs.normal_tree(ref.weight_shapes(cfg_d), gen, dtype,
                            cfg_d["init_scale"])
    return p0, inputs.normal(ref.batch_shape(cfg_d), gen, dtype)


def reference_outputs(cell, seed: int, device, mode: str = "f32"):
    """(the reference's checked steps in precision `mode`, the initial
    weights). The first gradient is the one SGD applied, read back from
    the parameters after step 1 as the program's is."""
    cfg_d = cell.config
    p0, x = _inputs(cell, seed, device)
    out = _reference(cell).train_steps(
        p0, x, cfg_d, int(cell.traffic["checked_steps"]), precision.product(mode))
    lr = cfg_d["optimizer"]["lr"]
    return ({"losses": out["losses"],
             "grad1": {k: (p0[k].float() - out["params1"][k]) / lr for k in p0},
             "change": {k: out["params"][k] - p0[k].float() for k in p0}}, p0)


def _rank_run(cell, mesh, ctrl, dev, job: dict) -> dict | None:
    """One job on this rank; rank 0 returns the outcome."""
    import torch.distributed as dist

    from kubeoperator_tpu_torch.parallel import validation_net as vnet
    from kubeoperator_tpu_torch.weights import local_shard
    from kubeoperator_tpu_torch.workloads.partition import gather_leaf

    cfg_d = cell.config
    rank = dist.get_rank()
    checked = int(cell.traffic["checked_steps"])
    seed, seconds, trace = job["seed"], job["seconds"], job["trace"]
    specs = vnet.param_specs()
    p0, x_global = _inputs(cell, seed, dev)
    params = {k: local_shard(v, specs[k], mesh) for k, v in p0.items()}
    x = local_shard(x_global, vnet.BATCH_SPEC, mesh)
    del p0, x_global
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prof = _profiler(dev.type) if trace else None
    flag = torch.zeros(1)
    with faults.plant("train_vnet", job.get("fault")):
        step = vnet.make_train_step(mesh, cfg=_net_config(cfg_d))
        p, losses = params, []
        for t in range(1, checked + 1):
            loss, p = step(p, x)
            losses.append(loss)
            if t == 1:
                p1 = _to_host(p)
        pn = _to_host(p)
        if prof is not None:          # the profiler's own start-up is set-up
            prof.start()
        _sync(dev)
        dist.barrier(group=ctrl)
        wall, start = time.time(), time.perf_counter()
        deadline = start + seconds
        steps = 0
        while True:
            loss, p = step(p, x)
            steps += 1
            if rank == 0:
                flag.fill_(float(time.perf_counter() >= deadline))
            dist.broadcast(flag, 0, group=ctrl)
            if flag.item():
                break
        float(p["w_head"].reshape(-1)[0])
        _sync(dev)
        dist.barrier(group=ctrl)
        window_s = time.perf_counter() - start
        if prof is not None:
            prof.stop()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    last_loss = float(loss)
    summary = tracing.summarize(*tracing.from_profiler(prof)) if prof else None
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (memory, summary, harness.forbidden_loaded(),
                                      math.isfinite(last_loss)), group=ctrl)
    whole = {name: {k: gather_leaf(v.to(dev), specs[k], mesh)
                    for k, v in tree.items()}
             for name, tree in (("p1", p1), ("pn", pn))}
    losses = [float(v) for v in losses]
    del params, p, p1, pn, step, x
    if rank != 0:
        del whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier(group=ctrl)
        return None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref, p0 = reference_outputs(cell, seed, dev)
    lr = cfg_d["optimizer"]["lr"]
    prog = {"losses": losses,
            "grad1": {k: (p0[k].float() - whole["p1"][k].float()) / lr for k in p0},
            "change": {k: whole["pn"][k].float() - p0[k].float() for k in p0}}
    readings = compare.train_readings(prog, ref)
    del whole, prog, ref, p0
    dist.barrier(group=ctrl)

    mesh_d = cfg_d["mesh"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tokens = cfg_d["b_local"] * mesh_d["dp"] * cfg_d["s_local"] * mesh_d["sp"]
    layer = {"steps": steps, "window_s": window_s, "chips": cell.chips,
             "step_flops": flops.vnet_step_flops(cfg_d, mesh_d),
             "peak_flops": peaks.bf16_flops(kind)}
    if trace:
        layer["trace"] = tracing.merge_ranks([g[1] for g in gathered])
    return {"window_start": wall,
            "e2e": {"train_tokens_per_s": steps * tokens / window_s},
            "layer": layer, "attempted": steps,
            "failed": sum(not g[3] for g in gathered),
            "kind": kind, "memory_peak_bytes": max(g[0] for g in gathered),
            "forbidden": sorted({m for g in gathered for m in g[2]}),
            "readings": readings}


def control(cell, seed: int, device) -> dict:
    """The control's readings: the reference in fp8 in the program's
    place, held against the reference in float32."""
    low, _ = reference_outputs(cell, seed, device, "fp8")
    ref, _ = reference_outputs(cell, seed, device)
    return compare.train_readings(low, ref)


def rank_main(payload: dict) -> int:
    import torch.distributed as dist

    from kubeoperator_tpu_torch.parallel import validation_net as vnet
    from kubeoperator_tpu_torch.parallel.mesh import mesh_sizes
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env

    cell = harness.load_cell(payload["root"], payload["cell"])
    dev = initialize_from_env(payload["device"])
    mesh = vnet.build_mesh_for(dev.type)
    if mesh_sizes(mesh) != cell.config["mesh"]:
        raise RuntimeError(f"mesh {mesh_sizes(mesh)} is not the configuration's "
                           f"{cell.config['mesh']}")
    ctrl = dist.new_group(backend="gloo")
    results = []
    try:
        for job in payload["jobs"]:
            if job.get("control"):
                out = control(cell, job["seed"], dev) \
                    if dist.get_rank() == 0 else None
                dist.barrier(group=ctrl)
            else:
                out = _rank_run(cell, mesh, ctrl, dev, job)
            results.append(out)
        if dist.get_rank() == 0:
            spawn.report(results)
    finally:
        dist.destroy_process_group()
    return 0


def run_jobs(cell, jobs: list, device: str = "cuda") -> list:
    return spawn.run_ranks("kobench.drivers.train_vnet",
                           {"root": str(cell.root), "cell": cell.name,
                            "device": device, "jobs": jobs},
                           cell.chips, RANK_TIMEOUT_S, device)


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: str | None = None) -> dict:
    return run_jobs(cell, [{"seed": seed, "seconds": seconds, "trace": trace,
                            "fault": fault}], device)[0]


if __name__ == "__main__":
    sys.exit(rank_main(json.loads(sys.argv[1])))
