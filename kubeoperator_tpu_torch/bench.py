"""The benchmark entry, ported (twin of the root `bench.py`): prints ONE
JSON line with the reference's contract, ``metric``, ``value``, ``unit``,
``vs_baseline`` and ``details``, whose keys are the reference's so one
parser reads both packages.

    python -m kubeoperator_tpu_torch.bench [--cpu]

Under the KO_TPU_* env contract every rank runs it and rank 0 prints the
line. Metric selection follows the reference:

  >= 2 ranks : psum all-reduce bus bandwidth over the card's data-sheet
               NVLink bandwidth for one direction (`nvlink_gbps_per_gpu`)
  1 rank     : the card's sustained bf16 tensor-core TFLOP/s over its
               data-sheet bf16 peak

A device the GPU registry does not know, the host included (``--cpu``,
or no card visible), is refused with ``error_no_gpu_visible``: no number
is made up for it. Wrong all-reduce values are refused with
``error_psum_incorrect``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from statistics import median

import torch
import torch.distributed as dist

from kubeoperator_tpu_torch.ops.collectives import bench_collective, verify_psum_correctness
from kubeoperator_tpu_torch.ops.dma_read import dma_read_bandwidth_gbps
from kubeoperator_tpu_torch.ops.hbm import hbm_bandwidth_gbps
from kubeoperator_tpu_torch.ops.longcontext_check import (
    bench_ring_attention,
    verify_ring_attention,
)
from kubeoperator_tpu_torch.ops.matmul import mxu_matmul_tflops
from kubeoperator_tpu_torch.ops.train_smoke import run_train_smoke
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.topology import generation_for_device
from kubeoperator_tpu_torch.parallel.validation_net import BENCH_CONFIG
from kubeoperator_tpu_torch.utils.device import device_kind
from kubeoperator_tpu_torch.workloads.harness import run_sweep

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the matmul sweep: (size, low iteration count), each differential span
# about a second of device time on the reference's chip
MXU_SWEEP = ((2048, 3400), (4096, 860), (8192, 60))


def prior_run_comparison(result: dict, here: str | None = None) -> dict | None:
    """Run-over-run visibility: the newest parseable BENCH_r*.json in
    `here` (default: the repo root) whose `details.device_kind` is this
    run's, with the headline delta and the deltas of the drift-prone
    details. A reading is never set against another device's: the
    reference's records are TPU runs. A >1% headline drop is flagged as a
    watch signal, not proof of a regression. Best effort: no exception
    sinks the headline."""
    here = here or REPO_ROOT
    kind = result["details"].get("device_kind")
    runs = sorted(glob.glob(os.path.join(here, "BENCH_r*.json")))
    for path in reversed(runs):
        try:
            with open(path, encoding="utf-8") as f:
                prior = json.load(f)
            parsed = prior.get("parsed") or prior  # a wrapped record, or the line
            prev_value = float(parsed["value"])
            prev_details = parsed.get("details", {})
            if not isinstance(prev_details, dict):
                prev_details = {}
            if prev_details.get("device_kind") != kind:
                continue
            out: dict = {"file": os.path.basename(path),
                         "metric": parsed.get("metric", "?"),
                         "value": prev_value}
            if parsed.get("metric") == result["metric"] and prev_value > 0:
                delta = (result["value"] - prev_value) / prev_value * 100.0
                out["headline_delta_pct"] = round(delta, 2)
                out["headline_watch"] = delta < -1.0
                # a delta across headline estimators is definitional, not a
                # regression: say so, and keep the flag down
                prev_protocol = prev_details.get("mxu_headline_protocol")
                cur_protocol = result["details"].get("mxu_headline_protocol")
                if cur_protocol and prev_protocol != cur_protocol:
                    out["headline_delta_note"] = (
                        "cross-protocol comparison: prior round used a "
                        "different headline estimator; see "
                        "mxu_headline_protocol and ops/matmul.py findings"
                    )
                    out["headline_watch"] = False
            detail_deltas = {}
            for key in ("hbm_triad_gbps", "dma_read_gbps", "train_mfu_pct",
                        "train_model_tflops_per_s"):
                prev = prev_details.get(key)
                cur = result["details"].get(key)
                if isinstance(prev, (int, float)) \
                        and isinstance(cur, (int, float)) and prev > 0:
                    detail_deltas[key] = round((cur - prev) / prev * 100.0, 2)
            if detail_deltas:
                out["detail_delta_pct"] = detail_deltas
            return out
        except Exception:
            continue
    return None


def _error(metric: str, details: dict) -> dict:
    return {"metric": metric, "value": 0, "unit": "none", "vs_baseline": 0,
            "details": details}


def _multi_rank(gen, details: dict) -> dict:
    """The >= 2-rank branch: psum gate, busbw sweep, ring attention, the
    workload sweep."""
    mesh = flat_axis_mesh()
    details["psum_correct"] = verify_psum_correctness(mesh)
    if not details["psum_correct"]:
        # bandwidth of an interconnect that sums wrong is not a health metric
        return _error("error_psum_incorrect", details)
    best = None
    for size in (8.0, 32.0, 64.0):
        r = bench_collective("psum", size_mb=size, mesh=mesh, iters=48)
        details[f"psum_busbw_{int(size)}mb"] = round(r.busbw_gbps, 2)
        if best is None or r.busbw_gbps > best:
            best = r.busbw_gbps
    details["ring_attention_correct"] = verify_ring_attention()
    details["ring_attention_tflops"] = bench_ring_attention(
        seq_per_device=1024, iters=6).to_dict()["tflops"]
    envelope = gen.nvlink_gbps_per_gpu
    # own try: a workload regression must not sink the interconnect headline
    try:
        sw = run_sweep(steps=4, peak_tflops_per_chip=gen.bf16_tflops_per_chip,
                       ici_envelope_gbps=envelope)
        details["workload_sweep_ok"] = sw["ok"]
        keep = ("axis", "devices", "mode", "steps_per_s",
                "model_tflops_per_s", "scaling_efficiency_pct", "mfu_pct")
        details["workload_rows"] = [
            {k: r[k] for k in keep if k in r} for r in sw["rows"]]
    except Exception as e:
        # a real False: consumers key on `if details["workload_sweep_ok"]`
        details["workload_sweep_ok"] = False
        details["workload_sweep_error"] = f"{type(e).__name__}: {e}"
    return {"metric": "psum_allreduce_busbw_gbps", "value": round(best, 2),
            "unit": "GB/s", "vs_baseline": round(best / envelope, 3),
            "details": details}


def _single_card(gen, dev: torch.device, details: dict) -> dict:
    """The 1-rank branch: the matmul sweep, the triad, the copy-kernel read
    stream (K1), the train smoke and the BENCH_CONFIG train rate."""
    best_m = None
    for size, lo_iters in MXU_SWEEP:
        m = mxu_matmul_tflops(size=size, iters=lo_iters, device=dev)
        details[f"mxu_tflops_{size}"] = m.tflops
        details[f"mxu_band_{size}"] = list(m.tflops_band)
        if best_m is None or m.tflops > best_m.tflops:
            best_m = m
    details["mxu_headline_band"] = list(best_m.tflops_band)
    details["mxu_headline_band_pct"] = round(best_m.band_pct, 1)
    # twice the reference's 2-4% run-to-run variance: a wider band makes
    # the headline suspect
    details["mxu_band_blowout"] = best_m.band_pct > 5.0
    details["mxu_headline_protocol"] = (
        "median of 7 wide-span differential draws")
    hs = [hbm_bandwidth_gbps(size_mb=256, iters=200, device=dev).gbps
          for _ in range(3)]
    details["hbm_triad_gbps"] = round(median(hs), 1)
    details["hbm_triad_band_gbps"] = [round(min(hs), 1), round(max(hs), 1)]
    if median(hs) > gen.hbm_gbps_per_chip * 1.05:
        details["hbm_triad_note"] = (
            "median exceeds the datasheet envelope — timing noise, not "
            "bandwidth; treat as ~ceiling")
    # each part in its own try: a diagnostic must not sink the headline
    try:
        d = dma_read_bandwidth_gbps(device=dev)
        details["dma_read_gbps"] = round(d.gbps, 1)
        details["hbm_datasheet_gbps"] = gen.hbm_gbps_per_chip
        if d.gbps > gen.hbm_gbps_per_chip:
            details["dma_read_note"] = (
                "exceeds datasheet envelope; treat as ~ceiling "
                "(differential-timing noise)")
    except Exception as e:
        details["dma_read_gbps"] = f"error: {type(e).__name__}"
    try:
        tr = run_train_smoke(steps=4, device=dev,
                             peak_tflops_per_chip=gen.bf16_tflops_per_chip)
        details["train_smoke_steps_per_s"] = tr["steps_per_s"]
        details["train_smoke_ok"] = tr["ok"]
    except Exception as e:
        details["train_smoke_ok"] = f"error: {type(e).__name__}"
    try:
        trb = run_train_smoke(steps=12, device=dev, cfg=BENCH_CONFIG,
                              peak_tflops_per_chip=gen.bf16_tflops_per_chip)
        details["train_model_tflops_per_s"] = trb["model_tflops_per_s"]
        details["train_mfu_pct"] = trb["mfu_pct"]
        details["train_bench_ok"] = trb["ok"]
    except Exception as e:
        details["train_bench_ok"] = f"error: {type(e).__name__}"
    return {"metric": f"{gen.name}_single_chip_mxu_bf16_tflops",
            "value": round(best_m.tflops, 1), "unit": "TFLOP/s",
            "vs_baseline": round(best_m.tflops / gen.bf16_tflops_per_chip, 3),
            "details": details}


def run_bench(dev: torch.device) -> dict:
    """The bench line's dict over the process group already joined on
    `dev` (`initialize_from_env`). Every rank calls it."""
    n = dist.get_world_size()
    gen = generation_for_device(dev)
    if gen is None:
        return _error("error_no_gpu_visible", {"device_kind": device_kind(dev)})
    details: dict = {"devices": n, "device_kind": device_kind(dev),
                     "generation": gen.name}
    result = (_multi_rank(gen, details) if n >= 2
              else _single_card(gen, dev, details))
    if result["metric"].startswith("error_"):
        return result
    prior = prior_run_comparison(result)
    if prior is not None:
        details["prior_run"] = prior
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host (gloo); refused as no GPU")
    args = parser.parse_args(argv)
    # with no card visible the host is what there is: refused like --cpu
    host = args.cpu or not torch.cuda.is_available()
    dev = initialize_from_env("cpu" if host else None)
    result = run_bench(dev)
    if dist.get_rank() == 0:
        print(json.dumps(result), flush=True)
    return 1 if result["metric"].startswith("error_") else 0


if __name__ == "__main__":
    sys.exit(main())
