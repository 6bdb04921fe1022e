"""`koctl` verbs of the port: local-device diagnostics and the train smoke.

    python -m kubeoperator_tpu_torch.cli.koctl tpu diag [--size 4096]
        [--iters 200] [--profile-dir DIR] [--cpu]
    python -m kubeoperator_tpu_torch.cli.koctl tpu train-smoke [--steps 4]
        [--cpu]

Counterparts of `cmd_tpu_diag` and `tpu train-smoke` in
`kubeoperator_tpu/cli/koctl.py`. The diag keeps the reference's report
keys and honesty guards, checked against this card's entry in
`parallel/topology.py` (`not_a_tpu` becomes `not_a_known_gpu`); the train
smoke prints its result and exits 0 only when it is ok.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.topology import generation_for_device
from kubeoperator_tpu_torch.utils.device import device_kind


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
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
