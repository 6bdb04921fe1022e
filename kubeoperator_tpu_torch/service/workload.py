"""The device seams of the control plane's workload verbs.

The reference's `WorkloadService` (`service/workload.py`), `WorkloadQueue`
(`service/queue.py`) and `SlicePool` (`resilience/slicepool.py`) stay
control-plane code of the JAX package; the port imports none of it. They
reach a device only through the call sites below, and import each function
inside the calling function's body, so a test that sets the module attribute
(`monkeypatch.setattr`) puts the port's function in its place. The services
are never edited to pick a backend.

=============================================  ==============================
reference call site                            port seam
=============================================  ==============================
service/workload.py:82-95 `_StepSampler`:      `on_step` gets a Python float
``float(jax.device_get(loss))``                loss, so device_get is the
                                               identity on it
service/workload.py:361-377, :612;             `visible_devices(device)`: the
service/queue.py:215, :336, :355;              cards, or with "cpu" a host
resilience/slicepool.py:200 ``jax.devices()``  count the caller names
service/workload.py:435, :653;                 `mesh_axes(mesh_like)`: the
resilience/slicepool.py:213                    port's `MeshSpec` of a JAX
``spec.build(devices[:n])``                    `Mesh`, a JAX `MeshSpec`, the
                                               port's, or ``{axis: n}``
service/workload.py:440, :655;                 `workloads/checkpoint.py::
resilience/slicepool.py:245                    restore_checkpoint`, which
``restore_checkpoint(dir, shapes())``          reads the reference's template
                                               (`ShapeDtypeStruct` leaves) by
                                               ``.shape`` and ``.dtype``
service/workload.py:500-506;                   `run_training(mesh_like, ...)`
resilience/slicepool.py:212-215                with the same keywords
``run_training(mesh, steps, mode, seed,
state, on_step, return_state,
checkpoint_every, on_checkpoint)``
service/workload.py:460-465, :889-896          `return_state` and
``tree_map(np.asarray(device_get(l)))``        `on_checkpoint` hand over a
                                               gathered tree of numpy leaves
                                               in the reference's tree
                                               order: that map is the
                                               identity on it
service/workload.py:692-695 `run_serving`      `run_serving(mesh_like, ...)`
with ``("stop", why)`` / ``("reshard", m)``    with the same keywords
service/workload.py:760-761 ``run_sweep(       `run_sweep(...)` over
steps, peak_tflops_per_chip)``                 `visible_devices()`
=============================================  ==============================

A test injects them as `tests/test_torch_service.py` does: ``jax.devices``
set to the first k of the virtual CPU devices (the reference's
`MeshSpec.build` then builds a real JAX mesh, which the seams read for its
shape only), and `kubeoperator_tpu.workloads.harness.run_training`,
`.run_sweep`, `kubeoperator_tpu.workloads.serve.run_serving` and
`kubeoperator_tpu.workloads.checkpoint.restore_checkpoint` set to these
functions with ``device="cpu"`` and the same k visible. One difference
stays: a corrupt checkpoint raises the port's `CheckpointError`, which the
slice pool's degrade leg (it catches the reference's) does not turn into a
from-scratch run.

How a seam runs, by the mesh's size k:

* k = 1 runs in the caller's process, on the card unless the caller asks
  for the CPU. With no process group it makes a one-rank group for the run
  and destroys it after, so it leaves none behind (a test process runs
  later tests; the service also calls it from background threads, and
  in-process runs take turns on one re-entrant lock).
* k > 1 starts k ranks, one process a card (gloo ranks with "cpu"), through
  the callback relay (`service/relay.py`): rank 0 reports each ``(completed,
  loss)`` and ``(served, latency_s)``, the callbacks run here as they
  arrive, and their verdicts reach every rank before its next step or
  request. Rank 0 gathers the trees handed to `on_checkpoint` and back
  under ``"state"``. A rank's failure raises `RankFailure`, whose text names
  the rank and ends with its stderr.

The sampler's timing split: `_StepSampler` calls ``input_s`` the time from
its previous fetch to this boundary and ``compute_s`` its own
``device_get``. Here the loss was fetched before the callback (in process by
`float`, over the relay by rank 0), so ``compute_s`` reads about 0 and
``input_s`` holds the whole step, plus, over the relay, the round trip to
rank 0. Neither is a device time.

bfloat16: numpy holds bfloat16 only through `ml_dtypes`, which the port
does not use, and a bf16 TrainState does not restore in either package
(ROADMAP C). A seam asked for a host tree of a bf16 run (`return_state` or
`on_checkpoint`) refuses before it starts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.service import relay as rl
from kubeoperator_tpu_torch.utils.device import resolve_device
from kubeoperator_tpu_torch.utils.errors import TopologyError, ValidationError
from kubeoperator_tpu_torch.workloads import harness, serve
from kubeoperator_tpu_torch.workloads.partition import (
    make_shard_and_gather_fns,
    replicated_specs,
    tree_map,
    tree_map_with_path,
    tree_paths,
)
from kubeoperator_tpu_torch.workloads.step import (
    WORKLOAD_AXES,
    make_train_step,
    param_shapes,
    train_state_shapes,
)

RANK_CODE = ("from kubeoperator_tpu_torch.service.workload import rank_main; "
             "rank_main()")
# in-process runs share the process's default group: one at a time (a
# callback may start a nested run on its own thread, hence re-entrant)
_IN_PROCESS = threading.RLock()


# ---------------------------------------------------------- devices ----
def visible_devices(device: torch.device | str | None = None,
                    count: int | None = None) -> list[int]:
    """The ranks a run may use, ``[0, ..., n-1]``: one a visible card, or on
    the host (``device="cpu"``) `count` of them (default 1)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return list(range(torch.cuda.device_count()))
    n = 1 if count is None else int(count)
    if n < 1:
        raise ValidationError(f"a host run needs at least 1 rank, not {n}")
    return list(range(n))


def mesh_axes(mesh_like) -> MeshSpec:
    """The port's `MeshSpec` of `mesh_like`: a JAX `Mesh` (read through
    ``.axis_names`` and ``.shape``), a JAX `MeshSpec` or the port's
    (``.axes``), ``{axis: n}``, or ``"data=2,fsdp=1"``."""
    if isinstance(mesh_like, MeshSpec):
        return mesh_like
    if isinstance(mesh_like, str):
        return MeshSpec.parse(mesh_like)
    if isinstance(mesh_like, dict):
        pairs = list(mesh_like.items())
    elif hasattr(mesh_like, "axes"):
        pairs = list(mesh_like.axes)
    elif hasattr(mesh_like, "axis_names") and hasattr(mesh_like, "shape"):
        pairs = [(name, mesh_like.shape[name]) for name in mesh_like.axis_names]
    else:
        raise TopologyError(
            f"cannot read mesh axes from {type(mesh_like).__name__}: want a "
            f"Mesh, a MeshSpec, {{axis: n}} or 'data=2,fsdp=1'")
    return MeshSpec(axes=tuple((str(name), int(n)) for name, n in pairs))


def _ranks_for(spec: MeshSpec, device, visible) -> int:
    """The mesh's size k, refused when more than `visible` (default
    `visible_devices(device)`) devices."""
    have = len(visible if visible is not None else visible_devices(device))
    if spec.total_devices > have:
        raise ValidationError(f"mesh {spec} needs {spec.total_devices} "
                              f"devices, {have} visible")
    return spec.total_devices


@contextlib.contextmanager
def _world_one(device):
    """A one-rank default group for an in-process run: the caller's, when
    it has one, else one made here and destroyed on the way out."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with _IN_PROCESS:
        made = not dist.is_initialized()
        if made:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            # not `initialize_from_env`: the caller's environment may hold
            # another run's KO_TPU_* variables
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
        elif dist.get_world_size() != 1 or dist.get_backend() != backend:
            raise TopologyError(
                f"an in-process run needs a one-rank {backend} group; this "
                f"process is rank {dist.get_rank()} of a "
                f"{dist.get_world_size()}-rank {dist.get_backend()} group")
        try:
            yield dev
        finally:
            if made:
                dist.destroy_process_group()


# ------------------------------------------------------------ trees ----
def _numpy_leaf(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValidationError(_BF16_REFUSAL)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


_BF16_REFUSAL = (
    "a bfloat16 TrainState cannot be handed over as numpy leaves (numpy "
    "holds bfloat16 only through ml_dtypes), and it would not restore in "
    "either package; run the checkpointed workload in float32")


def _on_template(tree, template, what: str):
    """`tree`'s leaves (a tree of either package's containers, or a flat
    ``{path: leaf}``), matched by path, in `template`'s containers."""
    flat = dict(tree_paths(tree))
    want = [path for path, _ in tree_paths(template)]
    if sorted(flat) != sorted(want):
        odd = sorted(set(flat) ^ set(want))
        raise ValidationError(f"{what} does not match the workload's tree "
                              f"(leaves {odd[:3]} differ)")
    return tree_map_with_path(lambda path, _: flat[path], template)


def _host_gather(mesh, cfg: NetConfig, mode: str):
    """Every rank's TrainState blocks → the global tree of numpy leaves, in
    the step's layout for (mesh, cfg, mode). Every rank calls it together."""
    _, specs, _ = make_train_step(mesh, cfg, mode=mode)
    if specs is None:
        specs = replicated_specs(train_state_shapes(cfg))
    _, gather = make_shard_and_gather_fns(mesh, specs)
    return lambda state: tree_map(_numpy_leaf, gather(state))


def _reshard_target(directive):
    """A serving directive with a reshard target as the port's MeshSpec."""
    if isinstance(directive, tuple) and directive and directive[0] == "reshard":
        return ("reshard", mesh_axes(directive[1]))
    return directive


def _encode_directive(directive):
    directive = _reshard_target(directive)
    if not directive:
        return None
    if isinstance(directive, str):
        return [directive]
    if directive[0] == "reshard":
        return ["reshard", [list(a) for a in directive[1].axes]]
    return [str(part) for part in directive]


def _decode_directive(encoded):
    if encoded is None:
        return None
    if encoded[0] == "reshard":
        return ("reshard", MeshSpec(axes=tuple((n, int(s)) for n, s in encoded[1])))
    return tuple(encoded)


# ------------------------------------------------------------ seams ----
def run_training(mesh_like, cfg: NetConfig | None = None, steps: int = 4,
                 mode: str = "auto", seed: int = 0, state=None, on_step=None,
                 return_state: bool = False, checkpoint_every: int = 0,
                 on_checkpoint=None, *, device=None, visible=None) -> dict:
    """The reference's `run_training(mesh, ...)` on the mesh's shape (module
    docstring): `state` is a host tree (numpy or tensor leaves, either
    package's containers), `on_step` gets float losses, and the trees
    handed to `on_checkpoint` and back under ``"state"`` are numpy."""
    spec = mesh_axes(mesh_like)
    cfg = cfg or NetConfig()
    k = _ranks_for(spec, device, visible)
    if (return_state or on_checkpoint is not None) and cfg.dtype == "bfloat16":
        raise ValidationError(_BF16_REFUSAL)
    if state is not None:
        state = _on_template(state, train_state_shapes(cfg), "the state")
    if k > 1:
        return _relayed("train", spec, cfg, device, k, state, dict(
            steps=steps, mode=mode, seed=seed, return_state=return_state,
            checkpoint_every=checkpoint_every,
            checkpoints=on_checkpoint is not None),
            on_step=on_step, on_checkpoint=on_checkpoint)
    with _world_one(device) as dev:
        mesh = spec.build(dev.type)
        host = (_host_gather(mesh, cfg, mode)
                if return_state or on_checkpoint is not None else None)

        def step_hook(completed, loss):
            return bool(on_step(completed, float(loss))) if on_step else False

        def checkpoint_hook(completed, live):
            on_checkpoint(completed, host(live))

        run = harness.run_training(
            mesh, cfg, steps=steps, mode=mode, seed=seed, state=state,
            on_step=step_hook, return_state=return_state,
            checkpoint_every=checkpoint_every,
            on_checkpoint=checkpoint_hook if on_checkpoint else None)
        if return_state:
            run["state"] = host(run["state"])
        return run


def run_serving(mesh_like, cfg: NetConfig | None = None, params=None,
                requests: int = 8, mode: str = "auto", seed: int = 0,
                slo_ms: float = 0.0, on_request=None, *, device=None,
                visible=None) -> dict:
    """The reference's `run_serving(mesh, ...)` on the mesh's shape: `params`
    a host param tree, `on_request` directives as the reference's, a
    reshard target any mesh `mesh_axes` reads."""
    spec = mesh_axes(mesh_like)
    cfg = cfg or NetConfig()
    k = _ranks_for(spec, device, visible)
    if params is not None:
        params = _on_template(params, param_shapes(cfg), "the params")
    if k > 1:
        return _relayed("serve", spec, cfg, device, k, params, dict(
            requests=requests, mode=mode, seed=seed, slo_ms=slo_ms),
            on_request=on_request)
    with _world_one(device) as dev:
        def request_hook(served, latency_s):
            return _reshard_target(on_request(served, latency_s)) \
                if on_request else None

        return serve.run_serving(
            spec.build(dev.type), cfg, params=params, requests=requests,
            mode=mode, seed=seed, slo_ms=slo_ms, on_request=request_hook)


def run_sweep(devices=None, cfg: NetConfig | None = None, steps: int = 4,
              mode: str = "auto", peak_tflops_per_chip: float | None = None,
              ici_envelope_gbps: float | None = None, axes=WORKLOAD_AXES, *,
              device=None) -> dict:
    """The reference's `run_sweep` over ``len(devices)`` ranks (default: every
    one `visible_devices(device)` gives)."""
    cfg = cfg or NetConfig()
    n = len(devices if devices is not None else visible_devices(device))
    kw = dict(steps=steps, mode=mode, peak_tflops_per_chip=peak_tflops_per_chip,
              ici_envelope_gbps=ici_envelope_gbps)
    if n > 1:
        return _relayed("sweep", MeshSpec(axes=(("ranks", n),)), cfg, device,
                        n, None, dict(kw, sweep_axes=list(axes)))
    with _world_one(device):
        return harness.run_sweep(devices=[0], cfg=cfg, axes=axes, **kw)


# ------------------------------------------------------------ relay ----
def _relayed(verb: str, spec: MeshSpec, cfg: NetConfig, device, k: int,
             tree, kw: dict, on_step=None, on_checkpoint=None,
             on_request=None) -> dict:
    """One k-rank run through the callback relay (module docstring)."""
    template = train_state_shapes(cfg)
    with rl.Relay(k) as relay:
        if tree is not None:
            rl.write_tree(relay.path("input"),
                          [(p, _numpy_leaf(leaf)) for p, leaf in tree_paths(tree)])
        relay.start(RANK_CODE, dict(
            verb=verb, device=resolve_device(device).type,
            axes=[list(a) for a in spec.axes], cfg=dataclasses.asdict(cfg),
            input=tree is not None, **kw))
        for event in relay.events():
            kind = event["kind"]
            if kind == "step":
                stop = bool(on_step(event["completed"], event["loss"])) \
                    if on_step else False
                relay.reply("step", event["completed"], {"stop": stop})
            elif kind == "checkpoint":
                on_checkpoint(event["completed"], _on_template(
                    rl.read_tree(event["dir"]), template, "a gathered state"))
                relay.reply("checkpoint", event["completed"], {})
            elif kind == "request":
                directive = on_request(event["served"], event["latency_s"]) \
                    if on_request else None
                relay.reply("request", event["served"],
                            {"directive": _encode_directive(directive)})
            else:
                record = event["record"]
                if event.get("state_dir"):
                    record["state"] = _on_template(
                        rl.read_tree(event["state_dir"]), template,
                        "the final state")
    return record


def rank_main() -> None:
    """The body of one relayed rank (`RANK_CODE`): join the group from the
    env contract, run the job, post rank 0's events and the record."""
    import os

    link = rl.RankLink(int(os.environ["KO_TPU_PROCESS_ID"]))
    job = link.job
    initialize_from_env(job["device"])
    cfg = NetConfig(**job["cfg"])
    spec = MeshSpec(axes=tuple((n, int(s)) for n, s in job["axes"]))
    tree = None
    if job["input"]:
        tree = rl.read_tree(os.path.join(link.dir, "input"))
    done: dict = {"kind": "done"}
    if job["verb"] == "train":
        mesh = spec.build()
        host = _host_gather(mesh, cfg, job["mode"])
        if tree is not None:
            tree = _on_template(tree, train_state_shapes(cfg), "the state")

        def on_step(completed, loss):
            link.report({"kind": "step", "completed": completed,
                         "loss": float(loss)})
            return link.reply("step", completed)["stop"]

        def on_checkpoint(completed, live):
            directory = os.path.join(link.dir, f"checkpoint-{completed}")
            gathered = host(live)
            if link.rank == 0:
                rl.write_tree(directory, tree_paths(gathered))
            link.report({"kind": "checkpoint", "completed": completed,
                         "dir": directory})
            link.reply("checkpoint", completed)

        run = harness.run_training(
            mesh, cfg, steps=job["steps"], mode=job["mode"], seed=job["seed"],
            state=tree, on_step=on_step, return_state=job["return_state"],
            checkpoint_every=job["checkpoint_every"],
            on_checkpoint=on_checkpoint if job["checkpoints"] else None)
        if job["return_state"]:
            gathered = host(run.pop("state"))
            done["state_dir"] = os.path.join(link.dir, "final")
            if link.rank == 0:
                rl.write_tree(done["state_dir"], tree_paths(gathered))
        done["record"] = run
    elif job["verb"] == "serve":
        if tree is not None:
            tree = _on_template(tree, param_shapes(cfg), "the params")

        def on_request(served, latency_s):
            link.report({"kind": "request", "served": served,
                         "latency_s": latency_s})
            return _decode_directive(link.reply("request", served)["directive"])

        done["record"] = serve.run_serving(
            spec.build(), cfg, params=tree, requests=job["requests"],
            mode=job["mode"], seed=job["seed"], slo_ms=job["slo_ms"],
            on_request=on_request)
    else:
        done["record"] = harness.run_sweep(
            cfg=cfg, steps=job["steps"], mode=job["mode"],
            peak_tflops_per_chip=job["peak_tflops_per_chip"],
            ici_envelope_gbps=job["ici_envelope_gbps"],
            axes=tuple(job["sweep_axes"]))
    link.report(done)
    dist.barrier()
    dist.destroy_process_group()
