"""`koctl` verbs of the port: local-device diagnostics, the train smoke and
the tenant workload verbs.

    python -m kubeoperator_tpu_torch.cli.koctl tpu diag [--size 4096]
        [--iters 200] [--profile-dir DIR] [--cpu]
    python -m kubeoperator_tpu_torch.cli.koctl tpu train-smoke [--steps 4]
        [--cpu]
    python -m kubeoperator_tpu_torch.cli.koctl workload train [--mesh M]
        [--steps N] [--mode MODE] [--checkpoint-dir DIR] [--resume [ID]]
        [--drain-at N] [--config default|bench-f32] [--cpu] [--json]
    python -m kubeoperator_tpu_torch.cli.koctl workload serve
        --checkpoint-dir DIR [--checkpoint ID] [--mesh M] [--requests N]
        [--slo-ms MS] [--mode MODE] [--config ...] [--cpu] [--json]
    python -m kubeoperator_tpu_torch.cli.koctl workload sweep [--steps N]
        [--config ...] [--cpu] [--json]
    python -m kubeoperator_tpu_torch.cli.koctl chaos-soak --preemption|--queue|
        --serve [--mesh M] [--seed N]
        [--verify-determinism] [--format json] [--work-dir DIR] [--config ...]
        [--cpu]

Counterparts of `cmd_tpu_diag`, `tpu train-smoke` and the device work of
`workload train|submit --kind serve|sweep` in `kubeoperator_tpu/cli/
koctl.py`. The diag keeps the reference's report keys and honesty guards,
checked against this card's entry in `parallel/topology.py` (`not_a_tpu`
becomes `not_a_known_gpu`); the train smoke prints its result and exits 0
only when it is ok.

The workload verbs run the device seams (`service/workload.py`) and the
port's checkpoints directly: the journal, tenants, plans and the queue stay
control-plane code. Each prints one record: ``result`` has the keys of the
reference op's result, ``windows`` the run's named wall-clock windows
(compile, steps, checkpoint-save/-restore with their bytes), ``device`` the
card, its peak memory and the launches of the hand-written kernels in this
process. The exit code is the reference's verdict: ``ok``, or ``finite`` for
a run stopped by `--drain-at` (which plays the service's `step_hook` drain:
this run stops after its N-th step and saves its checkpoint).

`chaos-soak` runs the device half of the reference's preemption, queue and
serving soaks (`service/drills.py`) and prints the reference's report
(``seed``, ``checks``, ``structure``, ``runtime_s``, ``deterministic`` with
--verify-determinism), plus the meshes, the runs' windows and the device
block; exit 0 when every check holds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.topology import generation_for_device
from kubeoperator_tpu_torch.utils.device import device_kind, resolve_device
from kubeoperator_tpu_torch.utils.errors import ValidationError


@contextlib.contextmanager
def _profile(profile_dir: str, dev: torch.device):
    """`torch.profiler` trace of the suite into `profile_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def cmd_tpu_diag(args) -> int:
    """Local diagnostics on this rank's card: tensor-core throughput, the
    memory triad, the explicit-copy read kernel and — with 2 or more ranks —
    the collective suite, the explicit ring all-gather and ring attention."""
    from kubeoperator_tpu_torch import ops

    dev = initialize_from_env("cpu" if args.cpu else None)
    n = dist.get_world_size()
    report: dict = {"devices": n, "device_kind": device_kind(dev)}
    profile = (_profile(args.profile_dir, dev) if args.profile_dir
               else contextlib.nullcontext())
    with profile:
        report["mxu"] = ops.mxu_matmul_tflops(
            size=args.size, iters=args.iters, device=dev).to_dict()
        gen = generation_for_device(dev)
        if gen is None:
            # a host run or an unknown part: readings are not card-health
            # numbers — flagged rather than fatal, since diag is also used
            # to eyeball a host
            report["not_a_known_gpu"] = (
                f"device kind {report['device_kind']!r} is not a known GPU "
                "part; readings are not card health numbers")
        elif report["mxu"]["tflops"] > gen.bf16_tflops_per_chip * 1.05:
            # a reading above the data-sheet peak is a measurement fault
            # (too short a window), never a healthy card
            report["mxu"]["suspect_short_window"] = (
                f"reading exceeds the {gen.name} data-sheet peak "
                f"({gen.bf16_tflops_per_chip} TFLOP/s); increase --iters "
                "until device time dominates timing jitter")
        # --iters plumbs here too (floored), so the guard's remedy
        # "increase --iters" lengthens the triad window it flags
        report["hbm_triad"] = ops.hbm_bandwidth_gbps(
            iters=max(args.iters, 200), device=dev).to_dict()
        report["dma_read"] = ops.dma_read_bandwidth_gbps(device=dev).to_dict()
        if gen is not None:
            for key in ("hbm_triad", "dma_read"):
                if report[key]["gbps"] > gen.hbm_gbps_per_chip * 1.05:
                    report[key]["suspect_short_window"] = (
                        f"reading exceeds the {gen.name} memory data sheet "
                        f"({gen.hbm_gbps_per_chip:g} GB/s); rerun — a "
                        "window that fits in L2 or is too short reads high")
            # two numbers, two questions: the one-pass triad is what a
            # fused elementwise kernel sustains, the copy kernel is the
            # read-stream peak; either alone misreads a card
            triad = report["hbm_triad"]["gbps"]
            dma = report["dma_read"]["gbps"]
            report["memory_health"] = {
                "fused_stream_sustained_gbps": triad,
                "fused_stream_role": (
                    "what a one-pass elementwise kernel (two reads, one "
                    "write) sustains; read it beside dma_peak_gbps, not "
                    "against the data sheet alone"),
                "dma_peak_gbps": dma,
                "dma_peak_role": (
                    "explicit double-buffered copy read stream (kernel K1) "
                    "against the data sheet; the number that speaks for "
                    "the memory parts themselves"),
                "datasheet_gbps": gen.hbm_gbps_per_chip,
                "fused_vs_datasheet": round(triad / gen.hbm_gbps_per_chip, 3),
                "dma_vs_datasheet": round(dma / gen.hbm_gbps_per_chip, 3),
            }
        if n >= 2:
            report["collectives"] = [
                r.to_dict() for r in ops.run_collective_suite()
            ]
            # the explicit ring (kernel K2) pins traffic to neighbour links,
            # so one slow link shows instead of being averaged away
            report["ring_all_gather_correct"] = ops.verify_ring_all_gather()
            report["pallas_ring"] = ops.bench_ring_all_gather().to_dict()
            # composed long-context path: exact ring attention over the ring
            report["ring_attention_correct"] = ops.verify_ring_attention()
            report["ring_attention"] = ops.bench_ring_attention(
                seq_per_device=256, iters=4).to_dict()
    if args.profile_dir:
        report["profile_dir"] = args.profile_dir
    print(json.dumps(report, indent=2))
    return 0


def cmd_tpu_train_smoke(args) -> int:
    """A few sharded training steps of the validation net over every rank."""
    from kubeoperator_tpu_torch.ops import run_train_smoke

    result = run_train_smoke(steps=args.steps,
                             device="cpu" if args.cpu else None)
    print(json.dumps(result, indent=2))
    return 0 if result["ok"] else 1


# ---------------------------------------------------------- workload ----
def _net_config(args):
    from kubeoperator_tpu_torch.parallel.validation_net import (
        BENCH_CONFIG,
        NetConfig,
    )

    # BENCH_CONFIG's dims in f32: a bf16 TrainState does not restore in
    # either package (ROADMAP C), and the verbs checkpoint
    if args.config == "bench-f32":
        return dataclasses.replace(BENCH_CONFIG, dtype="float32")
    return NetConfig()


def _visible(args, device, mesh_text: str) -> list[int]:
    """The cards; on the host (--cpu), as many ranks as the mesh names."""
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.service.workload import visible_devices

    if not args.cpu:
        return visible_devices(device)
    count = MeshSpec.parse(mesh_text).total_devices if mesh_text else 1
    return visible_devices(device, count)


def _find_checkpoint(root: str, ref: str) -> str:
    """The directory of a complete checkpoint under `root`: by id, unique
    prefix of at least 6 characters, or (no ref) the newest."""
    from kubeoperator_tpu_torch.workloads.checkpoint import (
        CheckpointError,
        load_manifest,
    )

    found = []
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        directory = os.path.join(root, name)
        try:
            found.append((load_manifest(directory), directory))
        except CheckpointError:
            continue
    if ref:
        found = [(m, d) for m, d in found
                 if m["id"] == ref or (len(ref) >= 6 and m["id"].startswith(ref))]
        if len(found) > 1:
            raise ValidationError(f"checkpoint ref {ref!r} is ambiguous "
                                  f"({len(found)} matches)")
    if not found:
        raise ValidationError(f"no complete checkpoint {ref!r} under {root}"
                              if ref else f"no complete checkpoint under {root}")
    return max(found, key=lambda md: (md[0]["created_at"], md[0]["id"]))[1]


def _restore(directory: str, cfg, windows: list):
    from kubeoperator_tpu_torch.workloads.checkpoint import restore_checkpoint
    from kubeoperator_tpu_torch.workloads.step import train_state_shapes

    t0 = time.time()
    state, manifest = restore_checkpoint(directory, train_state_shapes(cfg))
    windows.append({"name": "checkpoint-restore", "start": t0,
                    "end": time.time(),
                    "attrs": {"checkpoint": manifest["id"],
                              "step": manifest["step"],
                              "bytes": manifest["total_bytes"]}})
    return state, manifest


def _device_block(dev, visible: list[int]) -> dict:
    """The card and what this process saw of it."""
    from kubeoperator_tpu_torch.ops.dma_read import dma_read
    from kubeoperator_tpu_torch.ops.ring_gather import ring_all_gather

    return {
        "type": dev.type, "kind": device_kind(dev), "count": len(visible),
        # ranks of a relayed run live in other processes
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" and len(visible) == 1
                              else None),
        "kernel_launches": {"dma_read": dma_read.launches,
                            "ring_all_gather": ring_all_gather.launches},
    }


def _emit(args, kind: str, ok: bool, message: str, fields: dict) -> int:
    out = {"kind": kind, "ok": ok, "message": message, **fields}
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        result = out["result"]
        print(f"{kind}: {message}")
        for key in ("losses", "steps_per_s", "model_tflops_per_s",
                    "latency_p50_ms", "latency_p95_ms", "checkpoint"):
            if key in result:
                print(f"  {key}: {result[key]}")
    return 0 if ok else 1


def cmd_workload_train(args) -> int:
    """Sharded training on the mesh: `service.train`'s device work."""
    from kubeoperator_tpu_torch.service.workload import run_training, workload_spec
    from kubeoperator_tpu_torch.workloads.checkpoint import save_checkpoint
    from kubeoperator_tpu_torch.workloads.partition import explain_rules
    from kubeoperator_tpu_torch.workloads.step import (
        default_rules,
        train_state_shapes,
    )

    device = "cpu" if args.cpu else None
    dev = resolve_device(device)
    cfg = _net_config(args)
    resume = args.resume is not None
    windows: list[dict] = []
    state, manifest, seed = None, None, 0
    if resume:
        if not args.checkpoint_dir:
            raise ValidationError("--resume reads --checkpoint-dir")
        state, manifest = _restore(
            _find_checkpoint(args.checkpoint_dir, args.resume), cfg, windows)
        seed = int(manifest.get("seed", 0))
    if args.steps is None:
        steps = (max(manifest["target_steps"] - manifest["step"], 1)
                 if resume else 4)
    else:
        steps = int(args.steps)
    if steps < (1 if resume else 2):
        raise ValidationError("workload train --resume needs steps >= 1" if resume
                              else "workload train needs steps >= 2 — a single "
                              "step has no loss pair for the descending-loss "
                              "verdict")
    mesh_text = args.mesh
    if not mesh_text and resume and manifest["mesh"]:
        mesh_text = ",".join(f"{a}={n}" for a, n in manifest["mesh"].items())
    visible = _visible(args, device, mesh_text)
    spec = workload_spec(mesh_text, len(visible))
    mode = args.mode or "auto"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = run_training(
        spec, cfg=cfg, steps=steps, mode=mode, seed=seed, state=state,
        on_step=(lambda completed, _loss: args.drain_at is not None
                 and completed >= args.drain_at),
        return_state=bool(args.checkpoint_dir), device=device, visible=visible)
    final = run.pop("state", None)
    windows = run.pop("windows") + windows
    drained = bool(run["stopped_early"])
    if run["mode"] == "pjit":
        run["rules"] = explain_rules(default_rules(), train_state_shapes(cfg))
    gen = generation_for_device(dev)
    if gen is not None:
        run["mfu_pct"] = round(100.0 * run["model_tflops_per_s"]
                               / (gen.bf16_tflops_per_chip * run["devices"]), 3)
        run["peak_tflops_per_chip"] = gen.bf16_tflops_per_chip
    target = max(manifest["target_steps"], run["end_step"]) if resume else steps
    if args.checkpoint_dir:
        t0 = time.time()
        saved = save_checkpoint(
            args.checkpoint_dir, final, step=run["end_step"], target_steps=target,
            mesh=run["mesh"], losses=run["losses"], seed=seed)
        run["checkpoint"] = {"id": saved["id"], "step": saved["step"],
                             "target_steps": target, "dir": saved["dir"],
                             "bytes": saved["total_bytes"]}
        windows.append({"name": "checkpoint-save", "start": t0,
                        "end": time.time(),
                        "attrs": {"checkpoint": saved["id"],
                                  "step": saved["step"],
                                  "bytes": saved["total_bytes"]}})
    if resume:
        run["resumed_from"] = manifest["id"]
    if drained:
        run["drained"] = True
        run["drain_reason"] = f"--drain-at {args.drain_at}"
    ok = bool(run["finite"] if drained else run["ok"])
    message = (f"drained at step {run['end_step']}/{target}" if drained else
               f"loss {run['losses'][0]} -> {run['losses'][-1]} in "
               f"{run['steps']} steps ({run['steps_per_s']} steps/s, "
               f"{run['mode']})" if ok else
               f"training unhealthy: finite={run['finite']} "
               f"descending={run['descending']}")
    return _emit(args, "workload-train", ok, message, {
        "mesh": spec.describe(), "steps": steps, "mode": mode,
        "result": run, "windows": windows,
        "device": _device_block(dev, visible)})


def cmd_workload_serve(args) -> int:
    """Serve a checkpoint: `service.serve`'s device work."""
    from kubeoperator_tpu_torch.service.workload import run_serving, workload_spec

    device = "cpu" if args.cpu else None
    dev = resolve_device(device)
    cfg = _net_config(args)
    if args.requests < 1:
        raise ValidationError("workload serve needs requests >= 1")
    windows: list[dict] = []
    state, manifest = _restore(
        _find_checkpoint(args.checkpoint_dir, args.checkpoint), cfg, windows)
    mesh_text = args.mesh or ",".join(
        f"{a}={n}" for a, n in manifest["mesh"].items())
    visible = _visible(args, device, mesh_text)
    spec = workload_spec(mesh_text, len(visible))
    mode = args.mode or "auto"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = run_serving(spec, cfg, params=state["params"], requests=args.requests,
                      mode=mode, seed=int(manifest.get("seed", 0)),
                      slo_ms=args.slo_ms, device=device, visible=visible)
    windows += run.pop("windows")
    run["checkpoint_restored"] = manifest["id"]
    ok = bool(run["finite"] if run["drained"] else run["ok"])
    message = (f"served {run['served']} request(s) at {run['requests_per_s']} "
               f"req/s (p95 {run['latency_p95_ms']}ms)" if ok else
               f"serving unhealthy: finite={run['finite']}")
    return _emit(args, "workload-serve", ok, message, {
        "mesh": spec.describe(), "requests": args.requests, "mode": mode,
        "result": run, "windows": windows,
        "device": _device_block(dev, visible)})


def cmd_workload_sweep(args) -> int:
    """The scaling sweep over every visible card: `service.sweep`'s device
    work."""
    from kubeoperator_tpu_torch.service.workload import run_sweep

    device = "cpu" if args.cpu else None
    dev = resolve_device(device)
    if args.steps < 2:
        raise ValidationError("workload sweep needs steps >= 2 — each swept "
                              "mesh needs a loss pair for its health verdict")
    visible = _visible(args, device, "")
    gen = generation_for_device(dev)
    t0 = time.time()
    report = run_sweep(devices=visible, cfg=_net_config(args), steps=args.steps,
                       peak_tflops_per_chip=gen.bf16_tflops_per_chip if gen else None,
                       device=device)
    result = {k: report[k] for k in ("ok", "devices", "rows", "axes")}
    best = max((r["model_tflops_per_s"] for r in report["rows"]), default=0.0)
    return _emit(args, "workload-sweep", bool(report["ok"]),
                 f"swept {len(report['rows'])} meshes over {report['devices']} "
                 f"devices (best {best} model TFLOP/s)", {
                     "steps": args.steps, "result": result,
                     "windows": [{"name": "sweep", "start": t0,
                                  "end": time.time(),
                                  "attrs": {"meshes": len(report["rows"]),
                                            "devices": report["devices"]}}],
                     "device": _device_block(dev, visible)})


# -------------------------------------------------------- chaos soak ----
def cmd_chaos_soak(args) -> int:
    """The device half of `koctl chaos-soak --preemption|--queue|--serve`
    (`service/drills.py`): one pass, or two with --verify-determinism, whose
    structures must be equal. Exit 0 when every check holds."""
    import shutil
    import tempfile

    from kubeoperator_tpu_torch.service.drills import DRILLS, plan

    which = next(name for name in DRILLS if getattr(args, name))
    device = "cpu" if args.cpu else None
    dev = resolve_device(device)
    layout = plan(args.mesh)
    visible = _visible(args, device, str(layout.full))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    windows: list[dict] = []
    base = tempfile.mkdtemp(prefix=f"ko-{which}-drill-",
                            dir=args.work_dir or None)

    def one_pass(name: str, keep: list | None):
        return DRILLS[which](layout.full, _net_config(args), args.seed,
                             device=device, visible=visible,
                             work_dir=os.path.join(base, name), windows=keep)

    try:
        checks, structure = one_pass("pass1", windows)
        deterministic = None
        if args.verify_determinism:
            checks2, structure2 = one_pass("pass2", None)
            deterministic = (structure == structure2
                             and [c["ok"] for c in checks]
                             == [c["ok"] for c in checks2])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    ok = all(c["ok"] for c in checks) and deterministic in (None, True)
    report = {"seed": args.seed, "checks": checks, "structure": structure,
              "runtime_s": round(time.monotonic() - t0, 3)}
    if deterministic is not None:
        report["deterministic"] = deterministic
    report.update(mesh=str(layout.full), survivor_mesh=str(layout.survivor),
                  windows=windows, device=_device_block(dev, visible))
    if args.format == "json":
        print(json.dumps(report, indent=2))
        return 0 if ok else 1
    print(f"{which} chaos-soak (device half): seed={args.seed} mesh "
          f"{layout.full} -> survivor {layout.survivor} (shrunk "
          f"{layout.shrunk_axis})")
    if layout.shrunk_axis is None:
        print("  one device: no slice can be lost, the survivor mesh is the "
              "full mesh")
    for c in checks:
        mark = "ok " if c["ok"] else "FAIL"
        print(f"  [{mark}] {c['check']}"
              + (f" — {c['detail']}" if c["detail"] and not c["ok"] else ""))
    if deterministic is not None:
        print(f"  deterministic across two runs: {deterministic}")
    print(f"  runtime {report['runtime_s']}s — " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def _chaos_soak_parser(sub) -> None:
    soak = sub.add_parser(
        "chaos-soak", help="the device half of the preemption, queue and "
                           "serving chaos soaks")
    drill = soak.add_mutually_exclusive_group(required=True)
    drill.add_argument("--preemption", action="store_true",
                       help="a slice lost (the degrade leg from scratch on "
                            "the survivor mesh) and a maintenance notice "
                            "(drain, checkpoint, degrade-leg resume, full "
                            "resume), loss parity pinned")
    drill.add_argument("--queue", action="store_true",
                       help="alice drained by carol's priority at step 2, "
                            "carol and bob run, alice resumes; loss parity "
                            "pinned")
    drill.add_argument("--serve", action="store_true",
                       help="a server restores sierra's checkpoint and "
                            "re-shards onto the survivor mid-stream; tina "
                            "drained and resumed; uma runs")
    soak.add_argument("--mesh", default="data=2,fsdp=4", metavar="data=2,fsdp=4",
                      help="the full mesh; the survivor mesh loses one of "
                           "its two slices")
    soak.add_argument("--seed", type=int, default=0,
                      help="seeds every run of the drill (the reference "
                           "soaks' runs use 0)")
    soak.add_argument("--verify-determinism", action="store_true",
                      help="run the drill twice and compare the structures")
    soak.add_argument("--format", default="text", choices=["text", "json"])
    soak.add_argument("--work-dir", default="", metavar="DIR",
                      help="where the checkpoints go (removed after); "
                           "default: the temporary directory")
    soak.add_argument("--config", default="default",
                      choices=["default", "bench-f32"],
                      help="NetConfig: the default (tiny) one, or "
                           "BENCH_CONFIG's dims in float32")
    soak.add_argument("--cpu", action="store_true",
                      help="run on the host instead of the card (tests)")
    soak.set_defaults(func=cmd_chaos_soak)


def _workload_parser(sub) -> None:
    workload = sub.add_parser("workload", help="tenant workload verbs on the "
                              "card: train, serve, sweep")
    wsub = workload.add_subparsers(dest="wl_cmd", required=True)

    def common(p):
        p.add_argument("--config", default="default",
                       choices=["default", "bench-f32"],
                       help="NetConfig: the default (tiny) one, or "
                            "BENCH_CONFIG's dims in float32")
        p.add_argument("--cpu", action="store_true",
                       help="run on the host instead of the card (tests)")
        p.add_argument("--json", action="store_true")

    train = wsub.add_parser("train", help="sharded training on the mesh")
    train.add_argument("--mesh", default="", metavar="data=4,fsdp=2",
                       help="mesh axes over (data, fsdp, tp); default: the "
                            "checkpoint's on --resume, else every visible "
                            "device on the data axis")
    train.add_argument("--steps", type=int, default=None,
                       help="default 4, or what the checkpoint had left")
    train.add_argument("--mode", default="", choices=["", "auto", "pjit", "shard_map"])
    train.add_argument("--checkpoint-dir", default="", metavar="DIR",
                       help="save the final TrainState here; --resume reads it")
    train.add_argument("--resume", nargs="?", const="", default=None,
                       metavar="CHECKPOINT",
                       help="continue from the newest (or the named) complete "
                            "checkpoint under --checkpoint-dir")
    train.add_argument("--drain-at", type=int, default=None, metavar="N",
                       help="stop after this run's N-th step, as a drain does")
    common(train)
    train.set_defaults(func=cmd_workload_train)

    serve = wsub.add_parser("serve", help="answer requests from a checkpoint")
    serve.add_argument("--checkpoint-dir", required=True, metavar="DIR")
    serve.add_argument("--checkpoint", default="", metavar="ID",
                       help="default: the newest complete checkpoint")
    serve.add_argument("--mesh", default="", metavar="data=4,fsdp=2",
                       help="default: the checkpoint's")
    serve.add_argument("--requests", type=int, default=8)
    serve.add_argument("--slo-ms", type=float, default=0.0)
    serve.add_argument("--mode", default="", choices=["", "auto", "pjit", "shard_map"])
    common(serve)
    serve.set_defaults(func=cmd_workload_serve)

    sweep = wsub.add_parser("sweep", help="scaling sweep over the visible cards")
    sweep.add_argument("--steps", type=int, default=4)
    common(sweep)
    sweep.set_defaults(func=cmd_workload_sweep)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="koctl")
    sub = parser.add_subparsers(dest="cmd", required=True)
    tpu = sub.add_parser("tpu")
    tsub = tpu.add_subparsers(dest="tpu_cmd", required=True)
    diag_p = tsub.add_parser(
        "diag", help="local-device diagnostics (tensor cores/memory/copy)")
    diag_p.add_argument("--size", type=int, default=4096)
    diag_p.add_argument("--iters", type=int, default=200)
    diag_p.add_argument("--profile-dir", default="",
                        help="capture a torch.profiler trace of the suite")
    diag_p.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the card (tests)")
    diag_p.set_defaults(func=cmd_tpu_diag)
    train_p = tsub.add_parser(
        "train-smoke",
        help="run a few sharded training steps of the validation net")
    train_p.add_argument("--steps", type=int, default=4)
    train_p.add_argument("--cpu", action="store_true",
                         help="run on the host instead of the card (tests)")
    train_p.set_defaults(func=cmd_tpu_train_smoke)
    _workload_parser(sub)
    _chaos_soak_parser(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except ValidationError as e:
        # a refused request (bad flags, no checkpoint): the reason, not a
        # traceback, and exit 2 as argparse refuses
        print(f"koctl: {e.message}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
