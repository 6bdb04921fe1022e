"""Serving — the platform's second workload verb: hold a trained model's
forward function resident and answer batched requests under a latency SLO
(port of `workloads/serve.py`).

The seam mirrors training. `compile_forward` is `compile_step`'s
forward-only twin — pjit when the partition rules produced a spec tree,
shard_map otherwise — over the same model's `forward` and the same rules.
`run_serving` is the harness: a deterministic seeded request stream,
per-request latency samples, and an `on_request` hook, the serving twin of
training's `on_step`:

* ``("stop", why)`` — cooperative drain: stop at the next request boundary;
* ``("reshard", m)`` — degrade: carry on on mesh `m` (or on a `MeshSpec`
  built over the first ranks of the current mesh), the host params
  re-placed; the global batch shrinks with the mesh. A rank that is not a
  survivor stops, and its record says so (``drained``, ``drain_reason``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.parallel.mesh import (
    MeshSpec,
    format_axes,
    in_mesh,
    mesh_ranks,
    mesh_sizes,
)
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.workloads.partition import (
    PartitionError,
    make_shard_and_gather_fns,
    match_partition_rules,
    replicated_specs,
)
from kubeoperator_tpu_torch.workloads.step import (
    DATA_AXES,
    WORKLOAD_AXES,
    ModelConfig,
    build_batch,
    build_host_params,
    check_attention_width,
    check_workload_mesh,
    default_rules,
    gather_on_use,
    megatron_pair,
    model_of,
    param_shapes,
    resolve_mode,
)


def serve_rules(cfg=None):
    """Partition rules for the forward-only param tree — the training rules
    of `cfg`'s model verbatim; named separately so a serving layout can
    diverge."""
    return default_rules(cfg)


def compile_forward(mesh: DeviceMesh, cfg: ModelConfig | None = None,
                    specs=None, mode: str = "auto"):
    """The serve-side seam: returns ``(forward_fn, used)`` where
    ``forward_fn(params, x) -> y`` on this rank's blocks (y: this rank's
    batch rows) and ``used`` is the mode that runs. ``specs`` is the
    PARAMS-ONLY spec tree; ``mode`` is ``auto`` (pjit when specs exist, else
    shard_map), or a forced ``pjit`` / ``shard_map``."""
    cfg = cfg or NetConfig()
    forward = model_of(cfg).forward
    check_workload_mesh(mesh, "serving")
    check_attention_width(mesh, cfg)
    if resolve_mode(mode, specs) == "pjit":
        megatron = megatron_pair(specs)
        groups = {a: mesh.get_group(a) for a in WORKLOAD_AXES}
        tp = groups["tp"] if megatron else None

        @torch.no_grad()
        def global_forward(p, xb):
            whole = gather_on_use(
                {k: v for k, v in p.items() if k != "step"}, specs, groups,
                megatron)
            return forward(whole, xb, cfg, tp)

        return global_forward, "pjit"

    @torch.no_grad()
    def local_forward(p, xb):
        # params replicated, xb is this rank's (data, fsdp) batch block;
        # forward is per-example, so no collective is needed
        return forward(p, xb, cfg)

    return local_forward, "shard_map"


def make_forward(mesh: DeviceMesh, cfg: ModelConfig | None = None,
                 rules=None, mode: str = "auto"):
    """Rules → param specs → forward, in one call: returns
    ``(forward_fn, specs_or_None, used_mode)``. The forward of an
    `MlaMoeConfig` takes token ids and returns logits."""
    cfg = cfg or NetConfig()
    if mode == "shard_map":
        specs = None
    else:
        specs = match_partition_rules(
            rules if rules is not None else serve_rules(cfg),
            param_shapes(cfg))
    fn, used = compile_forward(mesh, cfg, specs=specs, mode=mode)
    return fn, None if used == "shard_map" else specs, used


def _digest(y: torch.Tensor, mesh: DeviceMesh) -> float:
    """The response read: sum(y²) / y.size over the GLOBAL output, in f32
    (this rank's rows summed, then summed over the data axes)."""
    sizes = mesh_sizes(mesh)
    total = torch.sum(y.float() ** 2)
    count = y.numel()
    for axis in DATA_AXES:
        if sizes[axis] > 1:
            dist.all_reduce(total, group=mesh.get_group(axis))
            count *= sizes[axis]
    return float(np.float32(total.item()) / np.float32(count))


def run_serving(mesh: DeviceMesh, cfg: NetConfig | None = None, params=None,
                requests: int = 8, mode: str = "auto", rules=None,
                seed: int = 0, slo_ms: float = 0.0, on_request=None):
    """Serve `requests` deterministic seeded batches on `mesh` and return the
    session record. Every rank of the mesh calls it together. `params` is a
    HOST param tree (a restored checkpoint's ``state["params"]``, or
    `gather_fn`'s); absent, a seeded fresh tree stands in. After every
    answered request, ``on_request(served, latency_s)`` may return a
    directive (module docstring). A `MeshSpec` reshard builds its mesh over
    the default group, so the mesh served on must then span all of it.

    Latencies are measured to answer-on-host (the digest read is the
    response); the first request warms up and the steady rate and the SLO
    verdict exclude it. ``outputs`` carries one digest per answered
    request."""
    cfg = cfg or NetConfig()
    requests = max(int(requests), 1)
    params_host = params if params is not None \
        else build_host_params(cfg, seed)
    windows: list[dict] = []

    def place(target_mesh, degraded: bool):
        t0 = time.time()
        fn, specs, used = make_forward(target_mesh, cfg, rules=rules, mode=mode)
        if specs is None:
            specs = replicated_specs(params_host)
        shard_fn, _ = make_shard_and_gather_fns(target_mesh, specs)
        placed = shard_fn(params_host)
        windows.append({
            "name": "serve-compile", "start": t0, "end": time.time(),
            "attrs": {"mode": used,
                      "devices": target_mesh.size(),
                      "degraded": degraded},
        })
        return fn, placed, used

    forward, params_dev, used = place(mesh, degraded=False)
    served = 0
    degraded = False
    drained = False
    drain_reason = ""
    latencies_s: list[float] = []
    outputs: list[float] = []
    t_session = time.time()
    wall0 = time.perf_counter()
    for i in range(requests):
        x = build_batch(mesh, cfg, seed=seed + 1000 + i)
        t0 = time.perf_counter()
        y = forward(params_dev, x)
        digest = _digest(y, mesh)
        latency = time.perf_counter() - t0
        served += 1
        latencies_s.append(latency)
        outputs.append(digest)
        directive = on_request(served, latency) if on_request else None
        if not directive:
            continue
        verb = directive[0] if isinstance(directive, tuple) else directive
        if verb == "stop":
            drained = True
            drain_reason = (directive[1]
                            if isinstance(directive, tuple)
                            and len(directive) > 1 else "")
            break
        if verb == "reshard":
            new_mesh = directive[1]
            if isinstance(new_mesh, MeshSpec):   # over the first ranks
                pool = mesh_ranks(mesh)
                if len(pool) != dist.get_world_size():
                    raise PartitionError(
                        "a MeshSpec reshard builds its mesh over the whole "
                        "process group; serve on a mesh that spans it, or "
                        "pass a built mesh")
                new_mesh = new_mesh.build(
                    mesh.device_type, ranks=pool[: new_mesh.total_devices])
            degraded = True
            if not in_mesh(new_mesh):
                drained = True
                drain_reason = (
                    f"resharded onto {format_axes(mesh_sizes(new_mesh))} "
                    f"without this rank")
                break
            mesh = new_mesh
            forward, params_dev, used = place(mesh, degraded=True)
    elapsed = time.perf_counter() - wall0
    windows.append({
        "name": "serving", "start": t_session, "end": time.time(),
        "attrs": {"served": served, "requests": requests,
                  "degraded": degraded},
    })

    finite = bool(np.isfinite(outputs).all()) if outputs else False
    steady = latencies_s[1:] if len(latencies_s) > 1 else latencies_s
    steady_p95 = (round(float(np.percentile(steady, 95)) * 1000.0, 3)
                  if steady else 0.0)
    record = {
        "ok": finite and served > 0,
        "finite": finite,
        "served": served,
        "requests": requests,
        "mode": used,
        "devices": mesh.size(),
        "mesh": mesh_sizes(mesh),
        "degraded": degraded,
        "requests_per_s": (round(served / elapsed, 3)
                           if elapsed > 0 else 0.0),
        "steady_requests_per_s": (round(len(steady) / sum(steady), 3)
                                  if steady and sum(steady) > 0 else 0.0),
        "latency_p50_ms": (round(float(np.percentile(latencies_s, 50))
                                 * 1000.0, 3) if latencies_s else 0.0),
        "latency_p95_ms": steady_p95,
        "slo_ms": float(slo_ms),
        "slo_met": (steady_p95 <= float(slo_ms)
                    if slo_ms and steady else True),
        "outputs": outputs,
        "windows": windows,
        # the drain protocol's shared vocabulary
        "drained": drained,
        "drain_reason": drain_reason,
        "end_step": served,
    }
    return record
