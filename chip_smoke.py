#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's kernels from `kubeoperator_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, drives the port's
node-validation path (`koctl tpu diag` at its defaults, then the Ready
gate `psum_smoke.main`) and shows that the path launched the kernels.

Phases; any failure ends the run with a non-zero exit and no result line:
  1. card name and power limit (nvidia-smi), the registry entry
  2. kernel build (one nvcc per source, all started together)
  3. K1 (dma_read) against its plain version at 256, 2048 and 62,464 rows
  4. K1 timing at 62,464 rows (256 MB): kernel, bound, plain, library
  5. `koctl tpu diag` in-process, with the launch counts set to 0 before
  6. `psum_smoke.main()` with KO_TPU_EXPECTED_CHIPS=1
Then the kernels line (JSON) and, last, the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A copy of everything measured goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# K1 tolerance on random input. The kernel and the plain version add the
# same f32 values in different orders (per-thread runs over a block's
# tiles, then a fixed-order sum of the block partials, against PyTorch's
# own reduction tree). At 62,464 rows each output sums 7,808 standard
# normals (magnitude ~90); the order difference is a random walk of f32
# roundings of about 1e-4 there, so 1e-3 absolute (plus 1e-5 relative)
# holds with room while a wrong row, tile or block would be off by ~1.
RTOL, ATOL = 1e-5, 1e-3
DIAG_SIZE_ROWS = (256, 2048, 62464)   # 62,464 rows = tpu diag's 256 MB


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def event_ms(fn, reps: int = 15, per_rep: int = 10) -> float:
    """Median per-call device time of `fn` (CUDA events around batches)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def capture(fn, *args):
    """Run fn(*args) with stdout captured; echo it; return (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    text = buf.getvalue()
    print(text, end="", flush=True)
    return rc, text


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from kubeoperator_tpu_torch.cli import koctl
    from kubeoperator_tpu_torch.ops import _build, psum_smoke
    from kubeoperator_tpu_torch.ops import dma_read as dma_mod
    from kubeoperator_tpu_torch.parallel.topology import generation_for_device

    dma_read, dma_read_reference = dma_mod.dma_read, dma_mod.dma_read_reference
    record: dict = {}

    # 1. card and registry entry
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(dev)
    gen = generation_for_device(dev)
    if gen is None:
        fail(f"{kind!r} is not in the port's GPU registry")
    print(f"phase 1: {kind} -> {gen}", flush=True)
    record.update(nvidia_smi=smi, kind=kind, registry=gen.__dict__,
                  torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    seconds = _build.build()
    print(f"phase 2: built {seconds} s", flush=True)
    for name in seconds:
        log = _build.build_log(name)
        print("\n".join(line for line in log.splitlines()
                        if "registers" in line or "smem" in line
                        or "spill" in line), flush=True)
    record["build_s"] = seconds

    # 3. K1 against its plain version
    max_abs_err = 0.0
    for rows in DIAG_SIZE_ROWS:
        seed = torch.tensor([3.0], device=dev)
        ones = torch.ones((rows, 1024), device=dev)
        out = dma_read(ones, seed)
        torch.cuda.synchronize()
        if not torch.equal(out, torch.full_like(out, rows / 8 + 3.0)):
            fail(f"K1 on ones at {rows} rows is not rows/8 + seed")
        if not torch.equal(out, dma_read_reference(ones, seed)):
            fail(f"K1 on ones at {rows} rows differs from the plain version")
        gen_rng = torch.Generator(device=dev).manual_seed(rows)
        x = torch.randn((rows, 1024), device=dev, generator=gen_rng)
        seed = torch.tensor([0.5], device=dev)
        out = dma_read(x, seed)
        ref = dma_read_reference(x, seed)
        exact = dma_read_reference(x.double(), seed.double())
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        err64 = float((out.double() - exact).abs().max())
        ref_err64 = float((ref.double() - exact).abs().max())
        if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
            fail(f"K1 at {rows} rows: max |kernel - plain| = {err}")
        max_abs_err = max(max_abs_err, err)
        print(f"phase 3: rows={rows} ones exact; randn max|k-plain|={err:.3g} "
              f"max|k-f64|={err64:.3g} max|plain-f64|={ref_err64:.3g} "
              f"(rtol={RTOL}, atol={ATOL})", flush=True)
        del ones, x
    base = torch.ones((256, 1024), device=dev)
    seed = torch.tensor([0.0], device=dev)
    invalid = {
        "rows % 256": (torch.ones((300, 1024), device=dev), seed),
        "float16": (base.half(), seed),
        "non-contiguous": (torch.ones((1024, 256), device=dev).t(), seed),
        "seed shape": (base, torch.zeros(2, device=dev)),
        "seed device": (base, torch.zeros(1)),
        "misaligned": (torch.ones(256 * 1024 + 1, device=dev)[1:]
                       .view(256, 1024), seed),
    }
    for what, (x_bad, s_bad) in invalid.items():
        try:
            dma_read(x_bad, s_bad)
        except ValueError:
            continue
        fail(f"K1 accepted invalid input ({what})")
    torch.cuda.synchronize()
    print(f"phase 3: {len(invalid)} invalid inputs raise ValueError",
          flush=True)

    # 4. K1 timing at the diag's size
    rows = DIAG_SIZE_ROWS[-1]
    x = torch.randn((rows, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    seed = torch.tensor([1.0], device=dev)
    kernel_ms = event_ms(lambda: dma_read(x, seed))
    plain_ms = event_ms(lambda: dma_read_reference(x, seed))
    library_ms = event_ms(lambda: torch.sum(x.view(-1, 8, 1024), 0))
    bytes_moved = rows * 1024 * 4 + 8 * 1024 * 4 + 4
    ops = rows * 1024 + 8 * 1024
    bytes_ms = bytes_moved / (gen.hbm_gbps_per_chip * 1e9) * 1e3
    ops_ms = ops / (gen.fp32_tflops_per_chip * 1e12) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    dma_read.launches = 0
    bw = dma_mod.dma_read_bandwidth_gbps()
    per_call = dma_read.launches
    print(f"phase 4: K1 rows={rows} kernel_ms={kernel_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} "
          f"kernel_gbps={rows * 4096 / kernel_ms / 1e6:.1f} "
          f"bandwidth_call={bw.to_dict()} launches_per_call={per_call}",
          flush=True)
    del x

    # 5. the main path: tpu diag at its defaults, counts from 0
    dma_read.launches = 0
    rc, text = capture(koctl.main, ["tpu", "diag"])
    diag_launches = dma_read.launches
    if rc != 0:
        fail(f"tpu diag exit {rc}")
    report = json.loads(text)
    for key in ("mxu", "hbm_triad", "dma_read", "memory_health"):
        if key not in report:
            fail(f"tpu diag report lacks {key!r}")
    readings = (report["mxu"]["tflops"], report["hbm_triad"]["gbps"],
                report["dma_read"]["gbps"])
    if not all(math.isfinite(v) and v > 0 for v in readings):
        fail(f"tpu diag readings not finite and positive: {readings}")
    if diag_launches == 0:
        fail("tpu diag did not launch K1")
    print(f"phase 5: tpu diag launched K1 {diag_launches} times", flush=True)

    # 6. the Ready gate on one card
    os.environ["KO_TPU_EXPECTED_CHIPS"] = "1"
    rc, text = capture(psum_smoke.main)
    lines = [ln for ln in text.splitlines()
             if ln.startswith("KO_TPU_SMOKE_RESULT ")]
    if rc != 0 or len(lines) != 1:
        fail(f"psum_smoke exit {rc}, {len(lines)} result lines")
    smoke = json.loads(lines[0].split(" ", 1)[1])
    if smoke["ok"] is not True or smoke["chips"] != 1:
        fail(f"smoke gate not ok: {smoke}")
    print("phase 6: smoke gate ok", flush=True)

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    kernels = {"kernels": [{
        "name": "dma_read", "route": "cuda",
        "source": "kubeoperator_tpu_torch/csrc/dma_read.cu",
        "replaces": "kubeoperator_tpu/ops/pallas_kernels.py:56",
        "launches": diag_launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }]}
    record.update(kernels=kernels, diag=report, smoke=smoke,
                  launches_per_bandwidth_call=per_call,
                  bandwidth_call=bw.to_dict(),
                  seconds=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=2))
    print(f"chip_smoke: {record['seconds']:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
