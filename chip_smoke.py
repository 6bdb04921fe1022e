#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR ...]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
`--parent DIR` also times the kernels of another checkout (unpacked with
`git archive`, say the parent commit) in a subprocess on the same card,
before phase 4 and after phase 8, and prints its times beside the tree's
(`parent_ms`: the first --parent's); phase 20 reports whether K3's forward
at (192, 128) gives that checkout's o and lse bit for bit. It may be given
more than once, and does not change what is checked.
It builds the port's kernels from `kubeoperator_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, drives the port's
node-validation path (`koctl tpu diag` at its defaults, then the Ready
gate `psum_smoke.main`), then the multi-device path's kernel and checks
(the explicit ring all-gather in its one-card form, ring attention), and
shows that each path launched its kernels.

Phases; any failure ends the run with a non-zero exit and no result line:
  1. card name and power limit (nvidia-smi), the registry entry
  2. kernel build (one nvcc per source, all started together)
  3. K1 (dma_read) against its plain version at 256, 2048 and 62,464 rows:
     exact on ones, within tolerance on randn, bit-identical run to run
  4. K1 timing at 62,464 rows (256 MB): kernel, bound, plain, library
  5. `koctl tpu diag` in-process, with the launch counts set to 0 before
  6. `psum_smoke.main()` with KO_TPU_EXPECTED_CHIPS=1
  7. K2 (ring_all_gather, one card, n virtual ranks) against its plain
     version: n = 2, 4, 8 in f32 and bf16 at the verify shape (arange) and
     the bench shape (3,904-row seeded randn shards) and a ragged-piece
     shape (1,001-row shards: no block's range is a whole number of
     pieces), bit-exact; 200 back-to-back launches at n = 8; invalid
     inputs raise ValueError
  8. K2 timing at n = 4 and 8 with 16 MB shards: kernel, bound, plain,
     library, and the time of writing its output alone; busbw of
     `bench_ring_all_gather(ranks=8)` (HBM to HBM)
  9. the multi-device path's entry points on one card, counts from 0:
     `verify_ring_all_gather(ranks=2, 4, 8)`, `bench_ring_all_gather
     (ranks=8)`, `verify_ring_attention()` causal and not,
     `bench_ring_attention(seq_per_device=256, iters=4)`
 10. with 2 or more cards only: 2 processes through the KO_TPU_* env
     contract, each running `tpu diag` and the gate at 2 chips with
     KO_TPU_TRAIN_STEPS=2 (mesh (1,1,1,2): the tp all-reduce pair over
     NCCL); both ranks must report `train.ok`; then the tenant workload
     across the two cards: `run_training` at the default config on
     (data=2), (fsdp=2) and (tp=2), the reference's losses, and a serve
     reshard from 2 ranks to 1
 11. the gate with training on one card: `psum_smoke.main()` with
     KO_TPU_TRAIN_STEPS=4 and KO_TPU_EXPECTED_CHIPS=1 (default NetConfig,
     f32, mesh (1,1,1,1)) must be ok with a finite, descending `train`
     block; then `koctl tpu train-smoke --steps 3` must exit 0
 12. the validation net at BENCH_CONFIG on one card (d_model 4096, d_ff
     32768, 8 heads, b_local 48, s_local 1024, bf16, remat none), 12
     steps as `bench.py` runs it: steps/s, model TFLOP/s, MFU against the
     registry's bf16 peak, the losses and peak memory; any non-finite
     loss fails the run, losses that do not descend are flagged
 13. the tenant workload (`workloads/`) at BENCH_CONFIG on mesh (data=1,
     fsdp=1, tp=1): `run_training(steps=12, mode="auto")` (the pjit
     path): steps/s, model TFLOP/s, MFU, peak memory; `run_serving` of
     the trained params (gathered to the host) for 4 requests: p50/p95
     and steady requests/s against the forward's bf16 bound; `python -m
     kubeoperator_tpu_torch.workloads.harness` in a subprocess; and at
     the default (f32) config the resume drill: 6 steps against 3 steps
     + save + restore + 3 steps, equal losses, which are the reference's
 14. the bench twin in-process on one card (`kubeoperator_tpu_torch.bench.
     main`), K1's count from 0: the metric `<part>_single_chip_mxu_bf16_
     tflops`, every `details` key of the reference's 1-device branch,
     `dma_read_gbps` a number with K1 launched, both train parts ok, no
     `prior_run` (the repo's records are TPU runs)
 15. the graft twin: `entry()`'s block (4 x 512 x 1024, bf16) on the card,
     finite and within a few bf16 steps of the same fn in f32 on the host;
     the block at 2 x 64 x 256 on the card equal to the host's bf16 run
     but for at most 1% of its entries, each within one bf16 step;
     `dryrun_multichip(1, device="cuda")` and `dryrun_multichip(4)` (4 gloo
     ranks)
 16. `run_dcn_smoke()` (4 gloo processes, dcn and ici psums 3.0), then
     Ulysses attention at world 1 on the card, causal and not: a smoke of
     its call path, since with one rank the all-to-alls return their input
     and it is reference attention; phase 10 holds it across two cards
 17. the control plane's device seams through the port's `koctl workload`
     verbs, each a subprocess, at BENCH_CONFIG's dims in float32 (a bf16
     TrainState does not restore in either package) on mesh (1,1,1): `train
     --steps 4`; `train --steps 4 --drain-at 2` into a checkpoint; `train
     --resume` of it (losses 1-2 and the resumed 3-4 must equal the first
     run's exactly); `serve --requests 4` from the resumed checkpoint;
     `sweep --steps 2` (its baseline's losses are the first run's first
     two). Free disk is checked first (two 4.03 GB checkpoints); printed:
     steps/s and model TFLOP/s, peak memory, checkpoint bytes and save and
     restore GB/s, serve p50/p95, the phase's wall time, K1 and K2
     launches in the verbs' processes
 18. the device half of the chaos soaks through the port's `koctl
     chaos-soak` verbs, each a subprocess on mesh data=1 (one card: the
     survivor mesh is the full mesh): `--preemption --config bench-f32`
     (BENCH_CONFIG's dims in f32): the loss scenario's degrade leg from
     scratch and its fresh twin, equal, whose 4 losses rise at this width,
     so the reference's verdict (finite and descending) fails its
     "continued" check, the one check allowed to fail, with exit 1; its
     losses are held to `BENCH_F32_LOSSES`; the notice scenario's 6 steps,
     drained at 2 into one 4.03 GB checkpoint, resumed by the degrade leg
     and on the full mesh (drained + resumed losses must equal the
     uninterrupted run's exactly); then `--queue` and `--serve` at the
     default config (the soaks' own size: a control-flow smoke, its
     latencies launch-bound), every check held. Free disk is checked first;
     printed: each drill's checks and wall time, the notice losses, the
     checkpoint's bytes and save and restore GB/s, serve p50, K1 and K2
     launches in the drills' processes; then the sweep and the checkpoint
     rows of `perf_rows.py` on the card in this process (the CI shapes of
     `perf_matrix.py`, K1 and K2 counted from 0 around them), whose round
     trip must be exact; its DCN row takes one card a rank, so phase 10
     prints it where 4 cards are visible
 19. K3, the fused causal attention (`ops/attention.py`, CUDA): against
     its plain version on the card at `ATTENTION_SHAPES` for the output and
     the three gradients, two backward runs bit-identical; then its forward
     and backward times at the train cells' shapes beside their bounds
     (the causal half of 2 and 4 products at 989 TFLOP/s), the plain
     version's and SDPA's (`library_ms`, a yardstick the port never calls),
     and each of its kernels' registers, spills and shared memory
 20. K3 at latent attention's widths (q and k 192, v 128 a view of the kv
     product, the scores times the softmax scale): against its plain
     version at `LATENT_SHAPES` (the reference a block of heads at a time),
     two runs bit-identical, each a launch of the pipelined forward walk
     and of the fused dK·dV walk; with --parent, o and lse against the
     other checkout's forward on the same inputs, bit for bit; then its
     forward and backward times at the Kimi-K2 cell's shape beside their
     bounds (forward q·kᵀ at 192 and P·v at 128, backward two of each
     width), each launch's time by kind (forward, D, dK·dV, dQ), and the
     pair's and `delta_kernel<128>`'s registers, spills and shared memory
Phase 10 also runs, over its 2 processes, the bench twin's >= 2-rank
branch (rank 0's line), Ulysses across the two cards, and then
`dryrun_multichip(2, device="cuda")`; with 4 or more cards,
`perf_rows.run_multislice("cuda")`, the DCN smoke's row (4 NCCL ranks,
one a card, dcn and ici psums 3.0); then the callback relay's 2-rank form: `koctl workload train
--mesh data=2` at the default config, uninterrupted, then drained at step 2
and resumed (one rank process a card), equal losses, the reference's;
then `koctl chaos-soak --preemption --mesh data=2` (survivor data=1).
The train path (phases 11-12), the workload (phase 13), the verbs
(phase 17) and the drills (phase 18) run neither K1 nor K2: their counts
are set to 0 before them (read from the verbs' processes for phases 17
and 18) and printed after them. Phase 13's bf16 training runs K3 through
the dense stage's attention, 5 launches a step (1 forward, 4 backward),
and prints its count; the f32 verbs and drills keep the plain chain.
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
import shutil
import statistics
import subprocess
import sys
import tempfile
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
RING_RANKS = (2, 4, 8)
RING_SHARD_ROWS = 3904                # bench_ring_all_gather's 16 MB shard
RING_RAGGED_ROWS = 1001               # 1,001-row shards: ragged pieces
RING_REPEATS = 200                    # back-to-back launches at n = 8
# the reference's `run_training` losses at the default NetConfig (f32, seed
# 0) on the host, as its records round them: 6 steps on one device, 4 on
# the two-device meshes of phase 10 (tests/test_torch_workloads.py holds
# them to the JAX package). The card's f32 products (no TF32) sum in
# other orders: 1e-5 relative, plus the records' rounding.
WORKLOAD_LOSSES = {
    "data=1,fsdp=1,tp=1": [0.174233, 0.068005, 0.028816, 0.017432, 0.014438,
                           0.013052],
    "data=2,fsdp=1,tp=1": [0.174858, 0.083324, 0.042316, 0.024327],
    "data=1,fsdp=2,tp=1": [0.174858, 0.083324, 0.042316, 0.024327],
    "data=1,fsdp=1,tp=2": [0.174233, 0.068005, 0.028816, 0.017432],
}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
# the port's own f32 losses at BENCH_CONFIG's dims on an H100, seed 0, on
# one card (phase 17's uninterrupted run; the reference's at this width are
# not measured): they rise after AdamW's first sign step
BENCH_F32_LOSSES = [4336.856445, 39621104.0, 32325288.0, 1965865.0]
# the one check phase 18's full-width preemption drill fails, as the
# reference's verdict rule fails it on those losses
CONTINUED_ON_ONE_CARD = ("[loss] workload continued on the survivor mesh "
                         "(the full mesh: one device loses no slice) "
                         "(1 device)")
# phase 17's TrainState at BENCH_CONFIG's dims in f32: 335,544,320
# parameters x 3 (params, mu, nu) x 4 B, plus the step and count scalars
CHAIN_STATE_BYTES = 335_544_320 * 3 * 4
SERVE_REQUESTS = 4          # each request draws a 201 M-value host batch
# the reference bench's 1-device `details` keys (bench.py:114-283), every
# one it always writes (tests/test_torch_bench.py holds them to it)
BENCH_N1_KEYS = frozenset(
    ["devices", "device_kind", "generation"]
    + [f"mxu_{k}_{n}" for n in (2048, 4096, 8192) for k in ("tflops", "band")]
    + ["mxu_headline_band", "mxu_headline_band_pct", "mxu_band_blowout",
       "mxu_headline_protocol", "hbm_triad_gbps", "hbm_triad_band_gbps",
       "dma_read_gbps", "hbm_datasheet_gbps", "train_smoke_steps_per_s",
       "train_smoke_ok", "train_model_tflops_per_s", "train_mfu_pct",
       "train_bench_ok"])
# the graft block on the card (bf16) against the same fn on f32 copies of
# its inputs on the host: bf16 roundings of O(1) outputs (a step is 2^-8
# relative), so a few steps
GRAFT_RTOL = GRAFT_ATOL = 2e-2
# the reduced block on the card against the host's bf16 run of it: equal
# but for f32 sums in another order that round the other way, at most 1%
# of the entries (0.04-0.3% between the host and the JAX reference; a
# missed rounding point or the exact gelu moves 3-15%), each within one
# bf16 step of the inputs' scale (|x| < 4) plus 2^-7 relative
GRAFT_REDUCED = (2, 64, 256)        # batch, seq, d_model
GRAFT_UNEQUAL = 0.01
GRAFT_STEP_RTOL, GRAFT_STEP_ATOL = 2 ** -7, 2 ** -6
# Ulysses against full attention, f32 without TF32: the reference's 2e-4
ULYSSES_TOL = 2e-4
ULYSSES_SHAPE = (2, 256, 8, 64)     # [batch, seq per rank, heads, head dim]
# K3 (fused causal attention) on the card: a ragged shape, then the train
# cells' shapes (dense-train 48 x 1024, dense-train-long 6 x 8192 tokens,
# 8 heads of 512), [batch, seq, heads, head dim]
ATTENTION_SHAPES = ((2, 333, 2, 512), (48, 1024, 8, 512), (6, 8192, 8, 512))
# K3 against its plain version, bf16 both ways: roundings of relative size
# 2^-9 or less an entry (S's f32 sums in another order, P rounded before
# normalising, dO·vᵀ kept f32, D from O), summed over random terms: under
# one bf16 step of each tensor's norm, a few steps of its largest entry
# (tests/test_torch_attention.py gives the same two limits)
ATTENTION_NORM_TOL, ATTENTION_MAX_TOL = 2 ** -8, 2 ** -5
# K3 at latent attention's widths: a ragged shape, then the Kimi-K2 cell's
# (3 rows of 8192 tokens, 64 heads), [batch, seq, heads]; the scale is
# 192^-1/2 · (0.1·ln 32 + 1)², which spreads the scores 1.81 times as wide
# as 1/sqrt(dh) does, so the norm's limit doubles
# (tests/test_torch_attention.py gives the same limits)
LATENT_SHAPES = ((1, 333, 4), (3, 8192, 64))
LATENT_NORM_TOL = 2 ** -7
LATENT_SCALE = 192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2


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


def check_ring(dev, rg) -> float:
    """Phase 7: K2 in its one-card form against its plain version and the
    input, bit for bit; returns the largest |kernel - plain| seen (0)."""
    import torch

    ring, plain = rg.ring_all_gather, rg.ring_all_gather_reference
    worst = 0.0
    for n in RING_RANKS:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(n)
            shapes = {
                "verify": torch.arange(8 * n * 1024, dtype=torch.float32,
                                       device=dev).view(8 * n, 1024),
                "bench": torch.randn((RING_SHARD_ROWS * n, 1024), device=dev,
                                     generator=gen),
                "ragged": torch.randn((RING_RAGGED_ROWS * n, 1024),
                                      device=dev, generator=gen),
            }
            for what, x in shapes.items():
                x = x.to(dtype)
                out = ring(x, ranks=n)
                ref = plain(x.view(n, -1, 1024))
                torch.cuda.synchronize()
                rg.raise_on_ring_error()
                if not torch.equal(out, x.expand(n, -1, -1)):
                    fail(f"K2 n={n} {dtype} {what}: output is not the input")
                if not torch.equal(out, ref):
                    fail(f"K2 n={n} {dtype} {what}: differs from the plain version")
                worst = max(worst, float((out.float() - ref.float()).abs().max()))
            print(f"phase 7: K2 n={n} {str(dtype)[6:]} verify, bench and "
                  "ragged-piece shapes bit-exact against the input and the "
                  "plain version", flush=True)
    # back to back, two inputs in turn: a race, or a slot read before it
    # was written, leaves the other input's bytes behind
    n = RING_RANKS[-1]
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randn((RING_SHARD_ROWS * n, 1024), device=dev, generator=gen)
          for _ in range(2)]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RING_REPEATS):
        x = xs[i % 2]
        bad += (ring(x, ranks=n) != x.expand(n, -1, -1)).sum()
    mismatches = int(bad.item())
    seconds = time.perf_counter() - t0
    rg.raise_on_ring_error()
    if mismatches:
        fail(f"K2: {mismatches} wrong elements over {RING_REPEATS} launches")
    print(f"phase 7: K2 {RING_REPEATS} back-to-back launches at n={n} all "
          f"exact ({seconds:.2f} s with the checks), error word clear",
          flush=True)
    ones = torch.ones(16 * 1024 + 4, device=dev)
    invalid = {
        "rows % n": (torch.ones((12, 1024), device=dev), 8),
        "misaligned": (ones[1:16 * 1024 + 1].view(16, 1024), 2),
        "non-contiguous": (torch.ones((1024, 16), device=dev).t(), 2),
        "n > 8": (torch.ones((72, 1024), device=dev), 9),
    }
    for what, (x_bad, n_bad) in invalid.items():
        try:
            ring(x_bad, ranks=n_bad)
        except ValueError:
            continue
        fail(f"K2 accepted invalid input ({what})")
    print(f"phase 7: {len(invalid)} invalid inputs raise ValueError", flush=True)
    return worst


def time_ring(dev, rg, hbm_gbps: float, parent: dict | None) -> dict:
    """Phase 8: K2 against its bound, its plain version, one broadcast
    copy and the writes of its output alone, per ring size, with 16 MB f32
    shards."""
    import torch

    rows = {}
    for n in (4, 8):
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((RING_SHARD_ROWS * n, 1024), device=dev, generator=gen)
        shards = x.view(n, RING_SHARD_ROWS, 1024)
        out = torch.empty((n, RING_SHARD_ROWS * n, 1024), device=dev)
        kernel_ms = event_ms(lambda: rg.ring_all_gather(x, ranks=n))
        plain_ms = event_ms(lambda: rg.ring_all_gather_reference(shards))
        library_ms = event_ms(
            lambda: out.copy_(x.unsqueeze(0).expand(n, -1, -1)))
        # the output's writes alone: a floor under any form of the ring
        write_ms = event_ms(lambda: out.fill_(0.0))
        rg.raise_on_ring_error()
        chunk_bytes = RING_SHARD_ROWS * 1024 * 4
        # least traffic: n outputs of n chunks written, each shard read once;
        # no arithmetic, so bytes bound it
        bound_ms = (n * n + n) * chunk_bytes / (hbm_gbps * 1e9) * 1e3
        # the one-card protocol's own traffic: step 0 reads each shard and
        # writes it twice (3n), each later step reads and writes one chunk
        # per rank (2n a step, n-2 steps): n(2n - 1) chunks
        protocol_ms = n * (2 * n - 1) * chunk_bytes / (hbm_gbps * 1e9) * 1e3
        parent_ms = parent.get(f"ring_n{n}_ms") if parent else None
        rows[n] = dict(kernel_ms=kernel_ms, bound_ms=bound_ms,
                       protocol_bytes_ms=protocol_ms, plain_ms=plain_ms,
                       library_ms=library_ms, chunk_bytes=chunk_bytes,
                       parent_ms=parent_ms, output_write_ms=write_ms)
        print(f"phase 8: K2 n={n} 16 MB shards kernel_ms={kernel_ms:.4f} "
              f"bound_ms={bound_ms:.4f} (bytes) "
              f"protocol_bytes_ms={protocol_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (broadcast copy) "
              f"output_write_ms={write_ms:.4f}"
              + (f" parent_ms={parent_ms}" if parent else ""), flush=True)
        del x, shards, out
    rg.ring_all_gather.launches = 0
    bench = rg.bench_ring_all_gather(ranks=8)
    per_call = rg.ring_all_gather.launches
    print(f"phase 8: bench_ring_all_gather(ranks=8) busbw="
          f"{bench.busbw_gbps:.1f} GB/s (HBM-to-HBM on one card, not a link "
          f"figure) launches_per_call={per_call}", flush=True)
    return dict(times=rows, bench=bench.to_dict(), launches_per_bench=per_call)


# run in a subprocess by --parent: another checkout's kernels, timed the
# same way on the same card
_PARENT_SCRIPT = """
import importlib.util, json, sys
import torch
sys.path.insert(0, {parent!r})
spec = importlib.util.spec_from_file_location("smoke_now", {smoke!r})
now = importlib.util.module_from_spec(spec)
spec.loader.exec_module(now)
from kubeoperator_tpu_torch.ops import _build, dma_read as d, ring_gather as rg
assert str(_build.CSRC).startswith({parent!r}), _build.CSRC
_build.build()
dev = torch.device("cuda", 0)
x = torch.randn(({k1_rows}, 1024), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
seed = torch.tensor([1.0], device=dev)
res = dict(dma_read_ms=now.event_ms(lambda: d.dma_read(x, seed)))
del x
for n in (4, 8):
    x = torch.randn(({k2_rows} * n, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n))
    res[f"ring_n{{n}}_ms"] = now.event_ms(lambda: rg.ring_all_gather(x, ranks=n))
    rg.raise_on_ring_error()
    del x
print("PARENT_RESULT " + json.dumps(res), flush=True)
"""


def time_parent(parent_dir: str) -> dict:
    """Times of the kernels of the checkout at `parent_dir`, in a subprocess
    on the same card."""
    script = _PARENT_SCRIPT.format(
        parent=str(Path(parent_dir).resolve()), smoke=str(ROOT / "chip_smoke.py"),
        k1_rows=DIAG_SIZE_ROWS[-1], k2_rows=RING_SHARD_ROWS)
    proc = subprocess.run([sys.executable, "-c", script], cwd=parent_dir,
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("PARENT_RESULT ")]
    if proc.returncode != 0 or not lines:
        fail(f"--parent run exit {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(lines[0].split(" ", 1)[1])


# run by each process of phase 10: tpu diag and the gate at 2 chips
_RANK_SCRIPT = """
import contextlib, io, json, sys
sys.path.insert(0, {root!r})
import torch, torch.distributed as dist
from kubeoperator_tpu_torch.cli import koctl
from kubeoperator_tpu_torch.ops import psum_smoke, ring_gather as rg
from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = koctl.main(["tpu", "diag"])
report = json.loads(buf.getvalue())
diag_launches = rg.ring_all_gather.launches
smoke = psum_smoke.run_smoke()
mesh = flat_axis_mesh()
n, rank = dist.get_world_size(), dist.get_rank()
x = torch.randn(({rows} * n, 1024), device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
local = x[rank * {rows}:(rank + 1) * {rows}]
gathered = torch.empty_like(x)
def ms(fn, reps=20):
    for _ in range(3):
        fn()
    dist.barrier()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
exact = torch.equal(rg.ring_all_gather(x, mesh), x)
kernel_ms = ms(lambda: rg.ring_all_gather(x, mesh))
library_ms = ms(lambda: dist.all_gather_into_tensor(gathered, local))
rg.raise_on_ring_error()
import chip_smoke
workload = chip_smoke.workload_ranks()
from kubeoperator_tpu_torch import bench
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    bench_rc = bench.main([])
ulysses = chip_smoke.ulysses_ranks(mesh)
print("RANK_RESULT " + json.dumps(dict(
    rank=rank, rc=rc, report=report, diag_launches=diag_launches, smoke=smoke,
    exact=exact, kernel_ms=kernel_ms, library_ms=library_ms,
    workload=workload, bench_rc=bench_rc, bench=buf.getvalue(),
    ulysses=ulysses)), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def workload_ranks() -> dict:
    """Phase 10's workload half, run by each of its 2 processes:
    `run_training` at the default config on (data=2), (fsdp=2) and (tp=2)
    across both ranks, then `run_serving` on (data=2) resharded onto rank 0
    alone after 2 of 4 requests."""
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.workloads import harness, serve

    out = {}
    for spec in ("data=2,fsdp=1,tp=1", "data=1,fsdp=2,tp=1", "data=1,fsdp=1,tp=2"):
        run = harness.run_training(MeshSpec.parse(spec).build(), steps=4)
        out[spec] = {k: run[k] for k in ("ok", "losses", "mode", "devices",
                                         "steps_per_s")}

    def reshard(served, _latency):
        if served == 2:
            return ("reshard", MeshSpec.parse("data=1,fsdp=1,tp=1"))
        return None

    rec = serve.run_serving(MeshSpec.parse("data=2,fsdp=1,tp=1").build(),
                            requests=4, on_request=reshard)
    out["reshard"] = {k: rec[k] for k in ("ok", "served", "degraded", "drained",
                                          "drain_reason", "devices", "outputs")}
    return out


def ulysses_ranks(mesh) -> dict:
    """Ulysses attention over the ranks of the 1-D `mesh` (one card each),
    causal and not, against reference attention on the whole arrays:
    the largest difference of this rank's shard."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubeoperator_tpu_torch.ops.longcontext_check import full_f32_matmul
    from kubeoperator_tpu_torch.parallel.longcontext import (
        reference_attention,
        ulysses_attention,
    )

    n, rank = dist.get_world_size(), dist.get_rank()
    s_local = ULYSSES_SHAPE[1]
    shape = (ULYSSES_SHAPE[0], s_local * n) + ULYSSES_SHAPE[2:]
    rng = np.random.default_rng(0)
    full = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for _ in range(3)]
    mine = [t[:, rank * s_local:(rank + 1) * s_local].contiguous() for t in full]
    err = {}
    with full_f32_matmul():
        for causal in (False, True):
            got = ulysses_attention(*mine, mesh, axis_name=mesh.mesh_dim_names[0],
                                    causal=causal)
            want = reference_attention(*full, causal=causal)
            want = want[:, rank * s_local:(rank + 1) * s_local]
            err[f"causal={causal}"] = float((got - want).abs().max())
    return err


def check_workload_ranks(results: list[dict]) -> None:
    """Phase 10: both ranks' training runs are the reference's, and the
    reshard leaves rank 0 serving alone."""
    for r in results:
        wl = r["workload"]
        for spec in ("data=2,fsdp=1,tp=1", "data=1,fsdp=2,tp=1", "data=1,fsdp=1,tp=2"):
            run = wl[spec]
            if not (run["ok"] and run["mode"] == "pjit" and run["devices"] == 2
                    and losses_match(run["losses"], spec)):
                fail(f"phase 10 rank {r['rank']} workload on {spec}: {run}")
    kept, left = (results[0]["workload"]["reshard"],
                  results[1]["workload"]["reshard"])
    if not (kept["served"] == 4 and kept["degraded"] and not kept["drained"]
            and kept["devices"] == 1 and left["served"] == 2 and left["drained"]
            and left["outputs"] == kept["outputs"][:2]):
        fail(f"phase 10 serve reshard 2 -> 1: rank 0 {kept}, rank 1 {left}")
    print(f"phase 10: workload across 2 cards: losses "
          + "; ".join(f"{s} {results[0]['workload'][s]['losses']}"
                      for s in ("data=2,fsdp=1,tp=1", "data=1,fsdp=2,tp=1",
                                "data=1,fsdp=1,tp=2"))
          + f" (the reference's); serve reshard 2 -> 1: rank 0 served "
          f"{kept['served']}, rank 1 stopped after {left['served']} "
          f"({left['drain_reason']})", flush=True)


def check_bench_ranks(results: list[dict], nvlink_gbps: float) -> dict:
    """Phase 10: the bench twin's >= 2-rank line, printed by rank 0 alone,
    with its gates passed and the headline over the card's NVLink figure."""
    if [r["bench_rc"] for r in results] != [0, 0] or results[1]["bench"]:
        fail(f"phase 10 bench: exit {[r['bench_rc'] for r in results]}, "
             f"rank 1 printed {results[1]['bench']!r}")
    line = json.loads(results[0]["bench"])
    d = line["details"]
    if not (line["metric"] == "psum_allreduce_busbw_gbps" and d["devices"] == 2
            and d["psum_correct"] and d["ring_attention_correct"]
            and d["workload_sweep_ok"] is True
            and line["vs_baseline"] == round(line["value"] / nvlink_gbps, 3)):
        fail(f"phase 10 bench line: {line}")
    print("phase 10: bench over 2 cards: " + json.dumps(line), flush=True)
    return line


def multi_card(torch) -> dict | None:
    """Phase 10: the process-per-card form of K2 through `tpu diag` and the
    gate in 2 processes, where 2 or more cards are visible."""
    if torch.cuda.device_count() < 2:
        print("phase 10: not run: 1 card visible; the process-per-card ring "
              "and the gate at 2 chips need 2 or more", flush=True)
        return None
    from kubeoperator_tpu_torch.parallel.multislice import HostEnv
    from kubeoperator_tpu_torch.utils.launch import free_port_pair, run_ranks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print("phase 10: cards: " + "; ".join(smi.splitlines()), flush=True)
    port = free_port_pair()
    envs = [dict(HostEnv(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=2, process_id=rank).to_env(),
                 KO_TPU_EXPECTED_CHIPS="2", KO_TPU_TRAIN_STEPS="2")
            for rank in range(2)]
    ran = run_ranks(_RANK_SCRIPT.format(root=str(ROOT), rows=RING_SHARD_ROWS),
                    envs, timeout_s=420)
    results = []
    for rc, out, err in ran:
        if rc != 0:
            fail(f"phase 10 rank exit {rc}: {err[-3000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("RANK_RESULT ")]
        results.append(json.loads(line[0].split(" ", 1)[1]))
    from kubeoperator_tpu_torch.parallel.topology import generation_for_device

    nvlink_gbps = generation_for_device(torch.device("cuda", 0)).nvlink_gbps_per_gpu
    chunk_bytes = RING_SHARD_ROWS * 1024 * 4
    bound_ms = chunk_bytes / (nvlink_gbps * 1e9) * 1e3  # (n - 1) chunks, n = 2
    for r in results:
        rep, smoke = r["report"], r["smoke"]
        train = smoke.get("train", {})
        if not (rep["ring_all_gather_correct"] and rep["ring_attention_correct"]
                and smoke["ok"] and smoke["ring_attention_correct"]
                and smoke["chips"] == 2 and r["exact"] and train.get("ok")
                and train.get("mesh") == {"dp": 1, "pp": 1, "sp": 1, "tp": 2}):
            fail(f"phase 10 rank {r['rank']}: {rep.get('ring_all_gather_correct')} "
                 f"{rep.get('ring_attention_correct')} {smoke}")
        if r["diag_launches"] == 0:
            fail(f"phase 10 rank {r['rank']}: tpu diag did not launch K2")
        print(f"phase 10: rank {r['rank']} tpu diag and gate ok at 2 chips; "
              f"K2 launches in diag={r['diag_launches']} "
              f"ring busbw={rep['pallas_ring']['busbw_gbps']:.1f} GB/s; "
              f"16 MB shard kernel_ms={r['kernel_ms']:.4f} "
              f"bound_ms={bound_ms:.4f} (one NVLink direction) "
              f"library_ms={r['library_ms']:.4f} (all_gather_into_tensor); "
              f"train at mesh {train['mesh']} ok, losses {train['losses']}",
              flush=True)
    check_workload_ranks(results)
    bench_line = check_bench_ranks(results, nvlink_gbps)
    for r in results:
        if not all(e <= ULYSSES_TOL for e in r["ulysses"].values()):
            fail(f"phase 10 rank {r['rank']} Ulysses across 2 cards: {r['ulysses']}")
    print(f"phase 10: Ulysses across 2 cards within {ULYSSES_TOL} of full "
          f"attention: {[r['ulysses'] for r in results]}", flush=True)
    from kubeoperator_tpu_torch.graft_entry import dryrun_multichip

    dryrun = dryrun_multichip(2, device="cuda")
    if dryrun["devices"] != 2 or dryrun["device_type"] != "cuda":
        fail(f"phase 10 dryrun_multichip(2, device='cuda'): {dryrun}")
    print(f"phase 10: dryrun_multichip(2, device='cuda') {dryrun}", flush=True)
    dcn = None
    if torch.cuda.device_count() >= 4:
        dcn = dcn_row_on_cards()
    else:
        print("phase 10: perf_rows.run_multislice('cuda') not run: it needs 4 "
              "cards", flush=True)
    relay = relay_two_cards()
    drill = drill_two_cards()
    multi = dict(cards=smi, ranks=results, bound_ms=bound_ms, bench=bench_line,
                 dryrun=dryrun, dcn=dcn, relay=relay, drill=drill)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_multi.json").write_text(json.dumps(multi, indent=2))
    return multi


def koctl_json(argv: list, phase: str, timeout: float) -> dict:
    """`python -m kubeoperator_tpu_torch.cli.koctl *argv` in a subprocess:
    the JSON it printed, with its ``exit_code`` and ``seconds``."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kubeoperator_tpu_torch.cli.koctl",
         *map(str, argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    try:
        out = json.loads(proc.stdout)
    except ValueError:
        fail(f"{phase}: koctl {' '.join(map(str, argv))} exit "
             f"{proc.returncode}: {proc.stderr[-3000:]}")
    out.update(exit_code=proc.returncode, seconds=time.perf_counter() - t0,
               stderr_tail=proc.stderr[-2000:])
    return out


def koctl_workload(*argv, phase: str, timeout: float = 600) -> dict:
    """`koctl workload *argv --json`: its record, whose ``ok`` must be its
    exit code's verdict."""
    out = koctl_json(["workload", *argv, "--json"], phase, timeout)
    if out["ok"] != (out["exit_code"] == 0):
        fail(f"{phase}: koctl workload {argv[0]} exit {out['exit_code']} with "
             f"ok={out['ok']}: {out['stderr_tail']}")
    return out


def koctl_soak(which: str, *argv, phase: str, timeout: float = 600,
               fails: tuple = ()) -> dict:
    """`koctl chaos-soak --<which> *argv --format json`: its report, which
    must exit 0 with every check ok, or, where `fails` names checks, exit 1
    with exactly those not ok."""
    out = koctl_json(["chaos-soak", f"--{which}", *argv, "--format", "json"],
                     phase, timeout)
    bad = [c for c in out["checks"] if not c["ok"]]
    if out["exit_code"] != (1 if fails else 0) \
            or [c["check"] for c in bad] != list(fails):
        fail(f"{phase}: koctl chaos-soak --{which} exit {out['exit_code']}, "
             f"failed checks {bad} (allowed: {list(fails)}): "
             f"{out['stderr_tail']}")
    return out


def dcn_row_on_cards() -> dict:
    """Phase 10 with 4 cards: `perf_rows.py`'s DCN row from the cards, the
    DCN smoke with one NCCL rank a card (dcn and ici psums 3.0)."""
    from kubeoperator_tpu_torch.perf_rows import run_multislice

    dcn = run_multislice("cuda")
    row = dcn["rows"][0]
    if not (dcn["ok"] and row["dcn_psum"] == 3.0 and row["ici_psum"] == 3.0):
        fail(f"phase 10 perf_rows.run_multislice('cuda'): {dcn}")
    print(f"phase 10: perf_rows DCN row from the cards ({row['processes']} "
          f"NCCL ranks, one a card): {json.dumps(row)}", flush=True)
    return dcn


def relay_two_cards() -> dict:
    """Phase 10's relay half: `koctl workload train --mesh data=2` at the
    default config, one rank process a card: uninterrupted, then drained at
    step 2 into a checkpoint and resumed; equal losses, the reference's."""
    spec = "data=2,fsdp=1,tp=1"
    root = ROOT / "build" / "chip_smoke" / "relay"
    shutil.rmtree(root, ignore_errors=True)
    full = koctl_workload("train", "--mesh", spec, "--steps", 4, phase="phase 10")
    drained = koctl_workload("train", "--mesh", spec, "--steps", 4, "--drain-at", 2,
                             "--checkpoint-dir", root, phase="phase 10")
    resumed = koctl_workload("train", "--resume", "--checkpoint-dir", root,
                             phase="phase 10")
    shutil.rmtree(root, ignore_errors=True)
    losses = drained["result"]["losses"] + resumed["result"]["losses"]
    if not (losses == full["result"]["losses"] and losses_match(losses, spec)
            and resumed["result"]["devices"] == 2
            and resumed["result"]["start_step"] == 2):
        fail(f"phase 10 relay: {drained['result']['losses']} + "
             f"{resumed['result']['losses']} against {full['result']['losses']}")
    print(f"phase 10: koctl workload train --mesh {spec} through the relay "
          f"(one rank process a card): drained at 2 + resumed = uninterrupted "
          f"{losses} (the reference's); {full['seconds']:.1f} + "
          f"{drained['seconds']:.1f} + {resumed['seconds']:.1f} s", flush=True)
    return dict(full=full, drained=drained, resumed=resumed)


def drill_two_cards() -> dict:
    """Phase 10's drill: `koctl chaos-soak --preemption --mesh data=2` at the
    default config, one rank process a card: the survivor mesh is data=1,
    where the degrade leg re-shards from scratch and resumes the notice
    scenario's 2-rank checkpoint."""
    rep = koctl_soak("preemption", "--mesh", "data=2", phase="phase 10")
    loss, notice = rep["structure"]["loss"], rep["structure"]["notice"]
    if not (loss["shrunk_axis"] == "data"
            and loss["degraded_mesh"] == "data=1,fsdp=1,tp=1"
            and notice["losses"] == notice["reference"]
            and losses_match(notice["reference"][:4], "data=2,fsdp=1,tp=1")):
        fail(f"phase 10 drill: {rep['structure']}")
    print(f"phase 10: koctl chaos-soak --preemption --mesh data=2 across the "
          f"two cards: {len(rep['checks'])} checks ok, survivor "
          f"{loss['degraded_mesh']}, notice losses {notice['losses']} = the "
          f"uninterrupted run's; {rep['seconds']:.1f} s", flush=True)
    return rep


def gbps(window: dict) -> float:
    return window["attrs"]["bytes"] / (window["end"] - window["start"]) / 1e9


def workload_chain(smi: str) -> dict:
    """Phase 17: the verbs chain train -> drain -> checkpoint -> resume ->
    serve, and the sweep, at BENCH_CONFIG's dims in f32 (module docstring)."""
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "chain"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    print(f"phase 17: {free / 1e9:.1f} GB free under {root} for two "
          f"{CHAIN_STATE_BYTES / 1e9:.2f} GB checkpoints", flush=True)
    if free < 2.2 * CHAIN_STATE_BYTES:
        fail(f"phase 17: {free} bytes free, two checkpoints need "
             f"{2 * CHAIN_STATE_BYTES}")
    wide = ("--config", "bench-f32")
    one = ("--mesh", "data=1,fsdp=1,tp=1")
    ckpt = ("--checkpoint-dir", root)
    try:
        full = koctl_workload("train", "--steps", 4, *one, *wide, phase="phase 17")
        drained = koctl_workload("train", "--steps", 4, "--drain-at", 2, *one,
                                 *ckpt, *wide, phase="phase 17")
        resumed = koctl_workload("train", "--resume", *ckpt, *wide,
                                 phase="phase 17")
        served = koctl_workload("serve", "--requests", 4, *ckpt, *wide,
                                phase="phase 17")
        swept = koctl_workload("sweep", "--steps", 2, *wide, phase="phase 17")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    verbs = dict(full=full, drained=drained, resumed=resumed, served=served,
                 swept=swept)
    run, d, r = full["result"], drained["result"], resumed["result"]
    losses = d["losses"] + r["losses"]
    if not (run["finite"] and losses == run["losses"] and d.get("drained")
            and r["start_step"] == 2 and r["resumed_from"] == d["checkpoint"]["id"]):
        fail(f"phase 17 chain: {d['losses']} + {r['losses']} is not "
             f"{run['losses']} (start_step {r['start_step']})")
    s = served["result"]
    if not (served["ok"] and s["served"] == 4 and s["mode"] == "pjit"
            and s["checkpoint_restored"] == r["checkpoint"]["id"]):
        fail(f"phase 17 serve: {s}")
    base = swept["result"]["rows"][0]
    if not (swept["result"]["devices"] == 1 and len(swept["result"]["rows"]) == 1
            and base["losses"] == run["losses"][:2]):
        fail(f"phase 17 sweep: {swept['result']}")
    launches = {k: sum(v["device"]["kernel_launches"][k] for v in verbs.values())
                for k in ("dma_read", "ring_all_gather")}
    save = next(w for w in drained["windows"] if w["name"] == "checkpoint-save")
    restore = next(w for w in resumed["windows"]
                   if w["name"] == "checkpoint-restore")
    peak_gb = full["device"]["peak_memory_bytes"] / 1e9
    seconds = time.perf_counter() - t0
    print(f"phase 17: koctl workload train at BENCH_CONFIG dims f32 on {smi}: "
          f"steps/s={run['steps_per_s']} model TFLOP/s={run['model_tflops_per_s']} "
          f"MFU={run.get('mfu_pct')}% (against the bf16 peak) peak memory="
          f"{peak_gb:.2f} GB; losses {run['losses']} (verdict ok={run['ok']})",
          flush=True)
    print(f"phase 17: drained at 2 + resumed {losses} = the uninterrupted "
          f"run's exactly; checkpoint {d['checkpoint']['bytes']} bytes, save "
          f"{gbps(save):.3f} GB/s, restore {gbps(restore):.3f} GB/s", flush=True)
    print(f"phase 17: serve --requests 4 from the resumed checkpoint: p50="
          f"{s['latency_p50_ms']} ms p95={s['latency_p95_ms']} ms (steady) "
          f"steady requests/s={s['steady_requests_per_s']}; sweep --steps 2: "
          f"baseline {base['losses']} = the first run's first two, ok="
          f"{swept['result']['ok']}", flush=True)
    print(f"phase 17: {seconds:.1f} s ("
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in verbs.items())
          + f"); K1 launched {launches['dma_read']} and K2 "
          f"{launches['ring_all_gather']} times in the verbs' processes "
          f"(they run neither)", flush=True)
    return dict(verbs=verbs, peak_memory_gb=peak_gb, save_gbps=gbps(save),
                restore_gbps=gbps(restore), launches=launches, seconds=seconds,
                free_bytes=free, nvidia_smi=smi)


def drill_phase(smi: str) -> dict:
    """Phase 18: the device half of the chaos soaks, `koctl chaos-soak` as
    subprocesses on mesh data=1 (module docstring), then the port's
    `perf_matrix.py` device rows."""
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "drills"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    print(f"phase 18: {free / 1e9:.1f} GB free under {root} for one "
          f"{CHAIN_STATE_BYTES / 1e9:.2f} GB checkpoint", flush=True)
    if free < 1.2 * CHAIN_STATE_BYTES:
        fail(f"phase 18: {free} bytes free, the notice scenario's checkpoint "
             f"needs {CHAIN_STATE_BYTES}")
    one = ("--mesh", "data=1", "--work-dir", root)
    try:
        drills = {
            "preemption --config bench-f32": koctl_soak(
                "preemption", "--config", "bench-f32", *one, phase="phase 18",
                timeout=900, fails=(CONTINUED_ON_ONE_CARD,)),
            "queue": koctl_soak("queue", *one, phase="phase 18"),
            "serve": koctl_soak("serve", *one, phase="phase 18"),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wide = drills["preemption --config bench-f32"]
    for name, rep in drills.items():
        print(f"phase 18: chaos-soak --{name} on {rep['mesh']}: "
              f"{rep['seconds']:.1f} s ({rep['runtime_s']} s in the drill), "
              f"exit {rep['exit_code']}; " + "; ".join(
                  c["check"] + ("" if c["ok"] else " NOT OK (as the "
                                "reference's verdict rule says)")
                  for c in rep["checks"]), flush=True)
    loss, notice = wide["structure"]["loss"], wide["structure"]["notice"]
    if not (loss["shrunk_axis"] is None
            and close_to(loss["losses"], BENCH_F32_LOSSES)
            and loss["losses"][-1] > loss["losses"][0]
            and notice["losses"] == notice["reference"]
            and close_to(notice["reference"][:4], BENCH_F32_LOSSES)
            and len(notice["losses"]) == 6 and notice["checkpoint_step"] == 2
            and notice["checkpoint_bytes"] >= CHAIN_STATE_BYTES):
        fail(f"phase 18 preemption: {notice}, {loss}")
    print(f"phase 18: at BENCH_CONFIG dims f32 the loss scenario's degrade "
          f"leg from scratch {loss['losses']} (= its fresh twin, = "
          f"BENCH_F32_LOSSES; rising, so not ok by the reference's rule); the "
          f"notice scenario drained at 2 + resumed {notice['losses']} against "
          f"the uninterrupted {notice['reference']}: equal; degrade leg (one "
          f"card: the full mesh) {notice['degraded_losses']}; peak memory "
          f"{wide['device']['peak_memory_bytes'] / 1e9:.2f} GB", flush=True)
    windows = wide["windows"]
    save = next(w for w in windows if w["name"] == "checkpoint-save")
    restores = [w for w in windows if w["name"] == "checkpoint-restore"]
    print(f"phase 18: checkpoint {save['attrs']['bytes']} bytes on {smi}: "
          f"save {gbps(save):.3f} GB/s, restore "
          + ", ".join(f"{gbps(w):.3f}" for w in restores) + " GB/s", flush=True)
    serving = {w["attrs"]["run"]: w["attrs"] for w in drills["serve"]["windows"]
               if w["name"] == "serving"}
    print("phase 18: serve p50 " + ", ".join(
        f"{run} {a['latency_p50_ms']} ms" for run, a in serving.items())
        + " (default config: a control-flow smoke, launch-bound, not a "
        "serving latency; phase 17 serves at full width)", flush=True)
    launches = {k: sum(r["device"]["kernel_launches"][k] for r in drills.values())
                for k in ("dma_read", "ring_all_gather")}
    print(f"phase 18: K1 launched {launches['dma_read']} and K2 "
          f"{launches['ring_all_gather']} times in the drills' processes (they "
          f"run neither)", flush=True)
    rows, row_launches, rows_s = perf_rows_on_the_card()
    seconds = time.perf_counter() - t0
    print(f"phase 18: {seconds:.1f} s (the perf rows {rows_s:.1f} s)",
          flush=True)
    return dict(drills=drills, save_gbps=gbps(save),
                restore_gbps=[gbps(w) for w in restores], launches=launches,
                perf_rows=rows, perf_rows_launches=row_launches,
                seconds=seconds, free_bytes=free, nvidia_smi=smi)


def close_to(got: list[float], want: list[float]) -> bool:
    return len(got) == len(want) and all(
        math.isclose(g, w, rel_tol=LOSS_RTOL, abs_tol=LOSS_ATOL)
        for g, w in zip(got, want))


def perf_rows_on_the_card() -> tuple[dict, dict, float]:
    """Phase 18's `perf_rows.py` rows on this card, in this process, K1 and
    K2 counted from 0 around them: the sweep and the checkpoint round trip
    (the CI shapes of `perf_matrix.py`). The DCN row takes one card a rank
    (4 cards): phase 10 prints it where they are visible."""
    from kubeoperator_tpu_torch import perf_rows
    from kubeoperator_tpu_torch.ops.dma_read import dma_read
    from kubeoperator_tpu_torch.ops.ring_gather import ring_all_gather

    t0 = time.perf_counter()
    dma_read.launches = 0
    ring_all_gather.launches = 0
    rows = {"workloads": perf_rows.run_workloads(),
            "checkpoint": perf_rows.run_checkpoint()}
    launches = dict(dma_read=dma_read.launches,
                    ring_all_gather=ring_all_gather.launches)
    if not (all(part["ok"] for part in rows.values()) and rows["workloads"]["rows"]
            and rows["checkpoint"]["rows"][0]["round_trip_exact"]):
        fail(f"phase 18: perf_rows {rows}")
    for name, part in rows.items():
        print(f"phase 18: perf_rows {name} (CI shapes) from the card: "
              + json.dumps(part["rows"]), flush=True)
    print("phase 18: perf_rows multislice not run on one card: the DCN row "
          "takes one card a rank (4); phase 10 prints it from 4 cards, phase "
          f"16 ran the same smoke on 4 gloo processes; K1 launched "
          f"{launches['dma_read']} and K2 {launches['ring_all_gather']} times "
          f"in the rows (they run neither)", flush=True)
    return rows, launches, time.perf_counter() - t0


def train_gate(koctl, psum_smoke) -> dict:
    """Phase 11: the gate with KO_TPU_TRAIN_STEPS=4 on one card, then
    `koctl tpu train-smoke --steps 3`."""
    os.environ["KO_TPU_EXPECTED_CHIPS"] = "1"
    os.environ["KO_TPU_TRAIN_STEPS"] = "4"
    try:
        rc, text = capture(psum_smoke.main)
    finally:
        del os.environ["KO_TPU_TRAIN_STEPS"]
    lines = [ln for ln in text.splitlines()
             if ln.startswith("KO_TPU_SMOKE_RESULT ")]
    if rc != 0 or len(lines) != 1:
        fail(f"psum_smoke with KO_TPU_TRAIN_STEPS=4 exit {rc}, "
             f"{len(lines)} result lines")
    smoke = json.loads(lines[0].split(" ", 1)[1])
    train = smoke.get("train")
    if not (smoke["ok"] is True and train and train["finite"]
            and train["descending"] and len(train["losses"]) == 4
            and train["mesh"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 1}):
        fail(f"gate with training not ok: {smoke}")
    print(f"phase 11: gate ok with train {train}", flush=True)
    rc, text = capture(koctl.main, ["tpu", "train-smoke", "--steps", "3"])
    if rc != 0:
        fail(f"koctl tpu train-smoke --steps 3 exit {rc}")
    cli = json.loads(text)
    print(f"phase 11: koctl tpu train-smoke --steps 3 exit 0, losses "
          f"{cli['losses']}", flush=True)
    return dict(gate=smoke, cli=cli)


def train_bench(gen, smi: str) -> dict:
    """Phase 12: the validation net at BENCH_CONFIG on one card, 12 steps."""
    import torch

    from kubeoperator_tpu_torch.ops.train_smoke import run_train_smoke
    from kubeoperator_tpu_torch.parallel import validation_net as vnet

    cfg = vnet.BENCH_CONFIG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_train_smoke(steps=12, peak_tflops_per_chip=gen.bf16_tflops_per_chip,
                          cfg=cfg)
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not res["finite"]:
        fail(f"BENCH_CONFIG losses not finite: {res['losses']}")
    trend = "descending" if res["descending"] else "**NOT DESCENDING**"
    step_flops = vnet.analytic_train_flops(vnet.mesh_spec_for(1), cfg)
    bound_s = step_flops / (gen.bf16_tflops_per_chip * 1e12)
    print(f"phase 12: BENCH_CONFIG on {smi}: steps/s={res['steps_per_s']} "
          f"model TFLOP/s={res['model_tflops_per_s']} MFU={res['mfu_pct']}% "
          f"step FLOPs={step_flops:.4g} (bf16 bound {bound_s:.4f} s a step) "
          f"peak memory={peak_gb:.2f} GB; losses {res['losses']} {trend}; "
          f"{seconds:.1f} s with the host build", flush=True)
    torch.cuda.empty_cache()
    return dict(result=res, peak_memory_gb=peak_gb, seconds=seconds,
                step_flops=step_flops, bf16_bound_s=bound_s, nvidia_smi=smi)


def losses_match(got: list[float], spec: str) -> bool:
    """`got` are the reference's first losses on mesh `spec`."""
    return close_to(got, WORKLOAD_LOSSES[spec][:len(got)])


def resume_drill(mesh, device_dir: Path) -> dict:
    """6 steps at the default config against 3 steps, a checkpoint of the
    gathered state, a restore and 3 more steps: the losses must be equal,
    and the reference's."""
    from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
    from kubeoperator_tpu_torch.workloads import checkpoint as ck
    from kubeoperator_tpu_torch.workloads import harness, partition, step

    cfg = NetConfig()
    full = harness.run_training(mesh, cfg, steps=6, seed=0)
    part = harness.run_training(mesh, cfg, steps=3, seed=0, return_state=True)
    _, specs, _ = step.make_train_step(mesh, cfg)
    _, gather = partition.make_shard_and_gather_fns(mesh, specs)
    device_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=device_dir) as root:
        man = ck.save_checkpoint(root, gather(part.pop("state")), step=3,
                                 target_steps=6, mesh=part["mesh"])
        back, _ = ck.restore_checkpoint(man["dir"], step.train_state_shapes(cfg))
    resumed = harness.run_training(mesh, cfg, steps=3, seed=0, state=back)
    losses = part["losses"] + resumed["losses"]
    if losses != full["losses"] or resumed["start_step"] != 3:
        fail(f"resume drill: {part['losses']} + {resumed['losses']} is not "
             f"{full['losses']} (start_step {resumed['start_step']})")
    if not losses_match(full["losses"], "data=1,fsdp=1,tp=1"):
        fail(f"resume drill: losses {full['losses']} are not the reference's "
             f"{WORKLOAD_LOSSES['data=1,fsdp=1,tp=1']}")
    print(f"phase 13: resume drill at the default config: 3 + save + restore "
          f"+ 3 steps give the 6-step losses exactly, the reference's "
          f"{full['losses']}; checkpoint {len(man['leaves'])} leaves, "
          f"{man['total_bytes']} bytes", flush=True)
    return dict(losses=full["losses"], leaves=len(man["leaves"]))


def workload_bench(gen, smi: str) -> dict:
    """Phase 13: the tenant workload at BENCH_CONFIG on one card (module
    docstring)."""
    import torch

    from kubeoperator_tpu_torch.parallel import validation_net as vnet
    from kubeoperator_tpu_torch.ops import attention
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.workloads import harness, partition, serve, step

    cfg = vnet.BENCH_CONFIG
    mesh = MeshSpec.parse("data=1,fsdp=1,tp=1").build("cuda")
    peak = gen.bf16_tflops_per_chip
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    attention.causal_attention.launches = 0
    t0 = time.perf_counter()
    run = harness.run_training(mesh, cfg, steps=12, mode="auto",
                               return_state=True)
    seconds = time.perf_counter() - t0
    k3_launches = attention.causal_attention.launches
    if k3_launches != 12 * (attention.LAUNCHES_FORWARD
                            + attention.LAUNCHES_BACKWARD[(512, 512)]):
        fail(f"12 bf16 workload steps launched K3 {k3_launches} times")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = run.pop("state")
    if run["mode"] != "pjit" or not run["finite"]:
        fail(f"workload at BENCH_CONFIG: mode {run['mode']}, losses {run['losses']}")
    step_flops = step.analytic_step_flops(mesh, cfg)
    bound_s = step_flops / (peak * 1e12)
    mfu = 100.0 * run["model_tflops_per_s"] / peak
    trend = "descending" if run["descending"] else "**NOT DESCENDING**"
    print(f"phase 13: run_training at BENCH_CONFIG on {smi}: mode={run['mode']} "
          f"steps/s={run['steps_per_s']} model TFLOP/s={run['model_tflops_per_s']} "
          f"MFU={mfu:.3f}% step FLOPs={step_flops:.5g} (bf16 bound {bound_s:.4f} s "
          f"a step) peak memory={peak_gb:.2f} GB; losses {run['losses']} {trend}; "
          f"{seconds:.1f} s with the host build; K3 launched {k3_launches} "
          f"times", flush=True)

    _, specs, _ = step.make_train_step(mesh, cfg)

    # serving the trained parameters, gathered to the host as a checkpoint
    # would hold them
    _, gather = partition.make_shard_and_gather_fns(mesh, specs["params"])
    host_params = gather(state["params"])
    del state
    torch.cuda.empty_cache()
    fwd_flops = step_flops / 3.0
    fwd_bound_ms = fwd_flops / (peak * 1e12) * 1e3
    t0 = time.perf_counter()
    rec = serve.run_serving(mesh, cfg, params=host_params, requests=SERVE_REQUESTS)
    serve_s = time.perf_counter() - t0
    if not (rec["ok"] and rec["served"] == SERVE_REQUESTS and rec["mode"] == "pjit"):
        fail(f"run_serving at BENCH_CONFIG: {rec}")
    print(f"phase 13: run_serving of the trained params, {SERVE_REQUESTS} "
          f"requests: p50={rec['latency_p50_ms']} ms p95={rec['latency_p95_ms']} ms "
          f"(steady) steady requests/s={rec['steady_requests_per_s']} against a "
          f"forward bound of {fwd_bound_ms:.2f} ms ({1e3 / fwd_bound_ms:.2f} "
          f"requests/s); digests {rec['outputs']}; {serve_s:.1f} s with the "
          f"host batches", flush=True)
    del host_params
    torch.cuda.empty_cache()

    # the job entry point, as the platform launches it
    proc = subprocess.run(
        [sys.executable, "-m", "kubeoperator_tpu_torch.workloads.harness"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("KO_TPU_WORKLOAD_RESULT ")]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"workloads.harness exit {proc.returncode}: {proc.stderr[-3000:]}")
    sweep = json.loads(lines[0].split(" ", 1)[1])
    base = sweep["baseline"]
    if not (sweep["ok"] and sweep["devices"] == 1
            and sweep.get("peak_tflops_per_chip") == peak
            and losses_match(base["losses"], "data=1,fsdp=1,tp=1")):
        fail(f"workloads.harness report: {sweep}")
    print(f"phase 13: python -m kubeoperator_tpu_torch.workloads.harness exit 0: "
          f"baseline {base}", flush=True)

    drill = resume_drill(mesh, ROOT / "build" / "chip_smoke")
    return dict(train=run, peak_memory_gb=peak_gb, seconds=seconds,
                k3_launches=k3_launches,
                step_flops=step_flops, bf16_bound_s=bound_s, mfu_pct=mfu,
                serve=rec, serve_seconds=serve_s,
                forward_bound_ms=fwd_bound_ms, harness=sweep,
                resume_drill=drill, nvidia_smi=smi)


def attention_phase(smi: str) -> dict:
    """Phase 19: K3 against its plain version on the card, bit-identical
    backward, its times at the train cells' shapes (module docstring).
    Alone: ``python3 -c "import chip_smoke; chip_smoke.attention_phase('')"``."""
    import torch
    import torch.nn.functional as F

    from kubeoperator_tpu_torch.ops import attention as k3

    dev = torch.device("cuda", 0)
    shapes = {}
    for b, s, h, dh in ATTENTION_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(s)
        qkv = torch.randn((b, s, 3 * h * dh), device=dev, generator=gen)
        qkv = qkv.bfloat16().requires_grad_()
        do = torch.randn((b, s, h * dh), device=dev, generator=gen).bfloat16()

        def heads():
            return [t.reshape(b, s, h, dh)
                    for t in torch.split(qkv, h * dh, dim=-1)]

        def run(fn):
            q, k, v = heads()
            out = fn(q, k, v)
            return [out.detach(), *torch.autograd.grad(out, (q, k, v), do)]

        got, again = run(k3.causal_attention), run(k3.causal_attention)
        want = run(k3.attention_reference)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w, a in zip(("o", "dq", "dk", "dv"), got, want, again):
            g, w = g.float(), w.float()
            errs[name] = dict(norm=float((g - w).norm() / w.norm()),
                              max=float((g - w).abs().max() / w.abs().max()),
                              bit_identical=bool(torch.equal(g, a.float())))
            if not (bool(torch.isfinite(g).all())
                    and errs[name]["norm"] <= ATTENTION_NORM_TOL
                    and errs[name]["max"] <= ATTENTION_MAX_TOL
                    and errs[name]["bit_identical"]):
                fail(f"K3 at {(b, s, h, dh)}: {name} {errs[name]}")
        del got, want, again
        torch.cuda.empty_cache()
        rec = dict(errors=errs)
        if (b, s) != ATTENTION_SHAPES[0][:2]:
            q, k, v = (t.detach() for t in heads())
            o, lse = k3._launch_forward(q, k, v)
            product = b * h * dh * s * (s + 1)  # one causal b·h·s²·dh product
            rec.update(
                fwd_ms=event_ms(lambda: k3._launch_forward(q, k, v), 5, 3),
                bwd_ms=event_ms(lambda: k3._launch_backward(
                    q, k, v, o, lse, do.reshape(b, s, h, dh)), 5, 1),
                fwd_bound_ms=2 * product / 989e12 * 1e3,
                bwd_bound_ms=4 * product / 989e12 * 1e3,
                resources=k3.kernel_resources())
            yardsticks = {
                "plain": (k3.attention_reference, lambda t: t, do),
                "library": (lambda *x: F.scaled_dot_product_attention(
                    *x, is_causal=True), lambda t: t.transpose(1, 2),
                    do.reshape(b, s, h, dh).transpose(1, 2))}
            for name, (fn, layout, dout) in yardsticks.items():
                x = [layout(t).detach().requires_grad_() for t in (q, k, v)]
                try:
                    with torch.no_grad():
                        fwd = event_ms(lambda: fn(*x), 3, 1)
                    both = event_ms(
                        lambda: torch.autograd.grad(fn(*x), x, dout), 3, 1)
                    rec[f"{name}_fwd_ms"], rec[f"{name}_bwd_ms"] = fwd, both - fwd
                except RuntimeError as e:       # out of memory, no kernel
                    rec[f"{name}_error"] = str(e)[:300]
                del x
                torch.cuda.empty_cache()
            del q, k, v, o, lse
        shapes[f"{b}x{s}x{h}x{dh}"] = rec
        print(f"phase 19: K3 at {(b, s, h, dh)} on {smi}: {json.dumps(rec)}",
              flush=True)
        del qkv, do
        torch.cuda.empty_cache()
    return dict(shapes=shapes, nvidia_smi=smi)


def latent_inputs(b: int, s: int, h: int, dev):
    """Phase 20's inputs at [b, s, h]: q, k [b, s, h, 192] and kv [b, s, h,
    256] (v its last 128 columns) needing gradients, dO [b, s, h, 128];
    bf16, drawn on the card from seed s."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(s)
    q, k = (torch.randn((b, s, h, 192), device=dev, generator=gen)
            .bfloat16().requires_grad_() for _ in range(2))
    kv = torch.randn((b, s, h, 256), device=dev, generator=gen).bfloat16()
    kv.requires_grad_()
    do = torch.randn((b, s, h, 128), device=dev, generator=gen).bfloat16()
    return q, k, kv, do


# run in a subprocess by phase 20 with --parent: another checkout's forward
# at (192, 128) on phase 20's inputs, o and lse saved for the comparison
_PARENT_FORWARD_SCRIPT = """
import importlib.util, sys
import torch
sys.path.insert(0, {parent!r})
spec = importlib.util.spec_from_file_location("smoke_now", {smoke!r})
now = importlib.util.module_from_spec(spec)
spec.loader.exec_module(now)
from kubeoperator_tpu_torch.ops import _build, attention as k3
assert str(_build.CSRC).startswith({parent!r}), _build.CSRC
dev = torch.device("cuda", 0)
for i, (b, s, h) in enumerate({shapes!r}):
    q, k, kv, _ = now.latent_inputs(b, s, h, dev)
    o, lse = k3._launch_forward(q.detach(), k.detach(), kv.detach()[..., 128:],
                                192, now.LATENT_SCALE)
    torch.save(dict(o=o.cpu(), lse=lse.cpu()), f"{out}/{{i}}.pt")
    del q, k, kv, o, lse
"""


def forward_bits_against(parent_dir: str, shapes) -> dict:
    """Whether this tree's forward at (192, 128) gives the o and lse of the
    checkout at `parent_dir`, bit for bit, on phase 20's inputs at each
    [b, s, h] of `shapes` (that checkout's run in a subprocess on the same
    card)."""
    import torch

    from kubeoperator_tpu_torch.ops import attention as k3

    dev = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        script = _PARENT_FORWARD_SCRIPT.format(
            parent=str(Path(parent_dir).resolve()),
            smoke=str(ROOT / "chip_smoke.py"), shapes=list(shapes), out=out)
        proc = subprocess.run([sys.executable, "-c", script], cwd=parent_dir,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"--parent forward exit {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        equal = {}
        for i, (b, s, h) in enumerate(shapes):
            q, k, kv, _ = latent_inputs(b, s, h, dev)
            o, lse = k3._launch_forward(q.detach(), k.detach(),
                                        kv.detach()[..., 128:], 192,
                                        LATENT_SCALE)
            want = torch.load(f"{out}/{i}.pt")
            equal[f"{b}x{s}x{h}"] = dict(
                o=bool(torch.equal(o.cpu(), want["o"])),
                lse=bool(torch.equal(lse.cpu(), want["lse"])))
            del q, k, kv, o, lse, want
            torch.cuda.empty_cache()
    return equal


def latent_attention_phase(smi: str, parents=()) -> dict:
    """Phase 20: K3 at (192, 128) against its plain version on the card,
    bit-identical runs, with `parents` (checkout directories) the forward's
    o and lse against each one's, its times at the Kimi-K2 cell's shape
    (module docstring). Alone: ``python3 -c "import chip_smoke;
    chip_smoke.latent_attention_phase('')"``."""
    import torch

    from kubeoperator_tpu_torch.ops import attention as k3

    dev = torch.device("cuda", 0)
    shapes = {}
    counters = ("pipelined_forward_launches", "fused_backward_launches")
    for b, s, h in LATENT_SHAPES:
        q, k, kv, do = latent_inputs(b, s, h, dev)

        def run():
            out = k3.causal_attention(q, k, kv[..., 128:], LATENT_SCALE)
            dq, dk, dkv = torch.autograd.grad(out, (q, k, kv), do.reshape(out.shape))
            return [out.detach().view(b, s, h, 128), dq, dk, dkv[..., 128:]]

        before = [getattr(k3.causal_attention, c) for c in counters]
        got, again = run(), run()
        walks = {c: getattr(k3.causal_attention, c) - n
                 for c, n in zip(counters, before)}
        if any(n != 2 for n in walks.values()):
            fail(f"K3 at {(b, s, h, 192, 128)}: 2 calls launched the "
                 f"pipelined walks {walks} times")
        errs = {name: dict(num=0.0, den=0.0, max_num=0.0, max_den=0.0)
                for name in ("o", "dq", "dk", "dv")}
        for h0 in range(0, h, 16):          # the plain chain, 16 heads a time
            sl = slice(h0, h0 + 16)
            x = [t[:, :, sl].detach().requires_grad_()
                 for t in (q, k, kv[..., 128:])]
            out = k3.attention_reference(*x, LATENT_SCALE)
            want = [out.detach().view(b, s, -1, 128),
                    *torch.autograd.grad(out, x, do[:, :, sl].reshape(out.shape))]
            for name, g, w in zip(errs, got, want):
                g, w = g[:, :, sl].float(), w.float()
                e = errs[name]
                e["num"] += float((g - w).square().sum())
                e["den"] += float(w.square().sum())
                e["max_num"] = max(e["max_num"], float((g - w).abs().max()))
                e["max_den"] = max(e["max_den"], float(w.abs().max()))
            del x, out, want
        for name, g, a in zip(errs, got, again):
            e = errs[name]
            errs[name] = dict(norm=math.sqrt(e["num"] / e["den"]),
                              max=e["max_num"] / e["max_den"],
                              bit_identical=bool(torch.equal(g, a)))
            if not (bool(torch.isfinite(g).all())
                    and errs[name]["norm"] <= LATENT_NORM_TOL
                    and errs[name]["max"] <= ATTENTION_MAX_TOL
                    and errs[name]["bit_identical"]):
                fail(f"K3 at {(b, s, h, 192, 128)}: {name} {errs[name]}")
        del got, again
        torch.cuda.empty_cache()
        rec = dict(errors=errs, calls=2, **walks)
        if (b, s) != LATENT_SHAPES[0][:2]:
            qd, kd, vd = q.detach(), k.detach(), kv.detach()[..., 128:]
            o, lse = k3._launch_forward(qd, kd, vd, 192, LATENT_SCALE)
            unit = b * h * s * (s + 1)      # a causal product per unit width
            rec.update(
                fwd_ms=event_ms(lambda: k3._launch_forward(
                    qd, kd, vd, 192, LATENT_SCALE), 5, 3),
                bwd_ms=event_ms(lambda: k3._launch_backward(
                    qd, kd, vd, o, lse, do, 192, LATENT_SCALE), 5, 1),
                kinds_ms=kinds_ms(k3, qd, kd, vd, o, lse, do),
                fwd_bound_ms=unit * (192 + 128) / 989e12 * 1e3,
                bwd_bound_ms=2 * unit * (192 + 128) / 989e12 * 1e3,
                resources={n: r for n, r in k3.kernel_resources().items()
                           if "x" in n or n == "delta128"})
            del qd, kd, vd, o, lse
        shapes[f"{b}x{s}x{h}x192x128"] = rec
        print(f"phase 20: K3 at {(b, s, h, 192, 128)} on {smi}: "
              f"{json.dumps(rec)}", flush=True)
        del q, k, kv, do
        torch.cuda.empty_cache()
    against = {}
    for d in parents:
        against[d] = forward_bits_against(d, LATENT_SHAPES)
        print(f"phase 20: forward o and lse bit-equal to --parent {d}'s: "
              f"{json.dumps(against[d])}", flush=True)
    return dict(shapes=shapes, forward_bits_against=against, nvidia_smi=smi)


def kinds_ms(k3, q, k, v, o, lse, do) -> dict:
    """Each launch of K3 at (192, 128) alone, by kind (ms): the forward,
    then the backward's in the order `BACKWARD` lists them."""
    import torch

    b, s, h, _ = q.shape
    lib = k3._library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_out = torch.empty_like(lse)
    ms = {"fwd": event_ms(lambda: k3._launch(
        "fwd", q, k, v, torch.empty_like(o), 192, LATENT_SCALE,
        lse_out=lse_out), 5, 3)}
    delta = torch.empty_like(lse)

    def d():
        k3._ok(lib.ko_attention_delta(128, o.data_ptr(), do.data_ptr(),
                                      delta.data_ptr(), b, h, s, stream),
               "delta")

    ms["delta"] = event_ms(d, 5, 3)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(o)
    outs = {"dkv": (dk, dv), "dq": (dq, None)}
    for kind in k3.BACKWARD[(192, 128)][1:]:
        out, out2 = outs[kind]
        ms[kind] = event_ms(lambda: k3._launch(
            kind, q, k, v, out, 192, LATENT_SCALE, do=do, lse=lse,
            delta=delta, out2=out2), 5, 1)
    return ms


def fwd_and_bwd(rec: dict, name: str) -> float | None:
    """A phase 19 yardstick's forward plus backward ms (None if it failed)."""
    if f"{name}_fwd_ms" not in rec:
        return None
    return rec[f"{name}_fwd_ms"] + rec[f"{name}_bwd_ms"]


def bench_phase(gen, smi: str, dma_mod) -> dict:
    """Phase 14: the bench twin in-process on one card, K1's count from 0:
    the reference's 1-device line and keys, K1 launched by its read
    stream."""
    from kubeoperator_tpu_torch import bench

    dma_mod.dma_read.launches = 0
    t0 = time.perf_counter()
    rc, text = capture(bench.main, [])
    seconds = time.perf_counter() - t0
    launches = dma_mod.dma_read.launches
    line = json.loads(text.strip().splitlines()[-1])
    d = line.get("details", {})
    missing = sorted(BENCH_N1_KEYS - set(d))
    if rc != 0 or line["metric"] != f"{gen.name}_single_chip_mxu_bf16_tflops":
        fail(f"bench twin exit {rc}: {line}")
    if missing:
        fail(f"bench twin details lack the reference's {missing}")
    if not (isinstance(d["dma_read_gbps"], float) and launches > 0):
        fail(f"bench twin dma_read_gbps {d['dma_read_gbps']!r}, K1 launches "
             f"{launches}")
    if d["train_smoke_ok"] is not True or d["train_bench_ok"] is not True:
        fail(f"bench twin train parts: {d['train_smoke_ok']!r} "
             f"{d['train_bench_ok']!r}")
    if "prior_run" in d:
        fail(f"bench twin compared itself with another device: {d['prior_run']}")
    print(f"phase 14: bench twin on {smi}: {seconds:.1f} s, K1 launched "
          f"{launches} times", flush=True)
    return dict(line=line, k1_launches=launches, seconds=seconds,
                nvidia_smi=smi)


def bf16_unequal(got, want) -> tuple[float, bool]:
    """The share of bf16 entries of `got` that are not `want`'s, and
    whether every entry is within GRAFT_STEP_ATOL + GRAFT_STEP_RTOL|want|."""
    import torch

    within = torch.allclose(got.float(), want.float(), rtol=GRAFT_STEP_RTOL,
                            atol=GRAFT_STEP_ATOL)
    return float((got != want).float().mean()), within


def graft_phase(dev) -> dict:
    """Phase 15: the graft twin: `entry()`'s block on the card against the
    same fn in f32 on the host, the reduced block on the card against the
    host's bf16 run, then the dry run on one card and on 4 gloo ranks."""
    import torch

    from kubeoperator_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    if not all(a.device.type == "cuda" for a in args):
        fail(f"entry() put its args on {[a.device for a in args]}")
    host = tuple(a.cpu() for a in args)
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    want = fn(*(a.float() for a in host))
    got = got.cpu()
    err = float((got.float() - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(want.shape)
            and torch.allclose(got.float(), want, rtol=GRAFT_RTOL, atol=GRAFT_ATOL)):
        fail(f"graft block on the card: max |card - host f32| = {err}")
    full_unequal, _ = bf16_unequal(got, fn(*host))
    small = graft_entry.block_inputs(*GRAFT_REDUCED)
    unequal, within = bf16_unequal(fn(*(a.to(dev) for a in small)).cpu(),
                                   fn(*small))
    if unequal > GRAFT_UNEQUAL or not within:
        fail(f"graft block {GRAFT_REDUCED} on the card against the host's bf16 "
             f"run: {unequal:.5f} of the entries differ, all within one step "
             f"{within}")
    print(f"phase 15: graft block {tuple(got.shape)} bf16 on the card within "
          f"rtol={GRAFT_RTOL} atol={GRAFT_ATOL} of the host's f32 run (max "
          f"|diff| {err:.4g}), {full_unequal:.5f} of its entries unlike the "
          f"host's bf16 run; block {GRAFT_REDUCED}: {unequal:.5f} unlike the "
          f"host's (limit {GRAFT_UNEQUAL}), {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = {}
    for n, device in ((1, "cuda"), (4, "cpu")):
        t0 = time.perf_counter()
        rep = graft_entry.dryrun_multichip(n, device=device)
        if rep["devices"] != n or rep["device_type"] != device:
            fail(f"dryrun_multichip({n}, {device!r}): {rep}")
        runs[f"{n}/{device}"] = dict(rep, seconds=time.perf_counter() - t0)
        print(f"phase 15: dryrun_multichip({n}, device={device!r}) {rep} "
              f"{runs[f'{n}/{device}']['seconds']:.1f} s", flush=True)
    return dict(block_max_abs_err=err, block_bf16_unequal=full_unequal,
                reduced_bf16_unequal=unequal, dryrun=runs)


def dcn_ulysses_phase(dev) -> dict:
    """Phase 16: the multislice smoke (4 gloo processes), then Ulysses at
    world 1 on the card, causal and not: a smoke of its call path (one
    rank's all-to-alls return their input, so it is reference attention;
    phase 10 holds it across two cards)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubeoperator_tpu_torch.ops.dcn_smoke import run_dcn_smoke
    from kubeoperator_tpu_torch.ops.longcontext_check import full_f32_matmul
    from kubeoperator_tpu_torch.parallel.longcontext import (
        reference_attention,
        ulysses_attention,
    )
    from kubeoperator_tpu_torch.parallel.mesh import flat_axis_mesh
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env

    dcn = run_dcn_smoke()
    if not (dcn["ok"] and dcn["dcn_psum"] == [3.0] and dcn["ici_psum"] == [3.0]):
        fail(f"run_dcn_smoke: {dcn}")
    print(f"phase 16: run_dcn_smoke ok: {dcn['processes']} processes, dcn "
          f"psum {dcn['dcn_psum']}, ici psum {dcn['ici_psum']}, "
          f"{dcn['wall_s']} s", flush=True)
    initialize_from_env(dev)
    mesh = flat_axis_mesh("sp")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(ULYSSES_SHAPE)
                                .astype(np.float32)).to(dev) for _ in range(3))
    err = {}
    with full_f32_matmul():
        for causal in (False, True):
            got = ulysses_attention(q, k, v, mesh, causal=causal)
            want = reference_attention(q, k, v, causal=causal)
            err[f"causal={causal}"] = float((got - want).abs().max())
    if not all(e <= ULYSSES_TOL for e in err.values()):
        fail(f"Ulysses at world 1 on the card: {err}")
    print(f"phase 16: Ulysses at world 1 on the card {ULYSSES_SHAPE} (a smoke: "
          f"one rank's all-to-alls are the identity) within {ULYSSES_TOL} of "
          f"full attention: {err}", flush=True)
    dist.destroy_process_group()
    return dict(dcn=dcn, ulysses_max_abs_err=err)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="also time the kernels of the checkout in DIR")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from kubeoperator_tpu_torch import ops as port_ops
    from kubeoperator_tpu_torch.cli import koctl
    from kubeoperator_tpu_torch.ops import _build, psum_smoke
    from kubeoperator_tpu_torch.ops import ring_gather as rg
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
                        or "spill" in line or "entry function" in line),
              flush=True)
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
        again = [dma_read(x, seed) for _ in range(3)]
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        err64 = float((out.double() - exact).abs().max())
        ref_err64 = float((ref.double() - exact).abs().max())
        if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
            fail(f"K1 at {rows} rows: max |kernel - plain| = {err}")
        if not all(torch.equal(out, a) for a in again):
            fail(f"K1 at {rows} rows: not bit-identical from run to run")
        max_abs_err = max(max_abs_err, err)
        print(f"phase 3: rows={rows} ones exact; randn max|k-plain|={err:.3g} "
              f"max|k-f64|={err64:.3g} max|plain-f64|={ref_err64:.3g} "
              f"(rtol={RTOL}, atol={ATOL}); 4 runs bit-identical", flush=True)
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

    # 4. K1 timing at the diag's size (the other checkout's first, if asked)
    parents = {d: [time_parent(d)] for d in args.parent}
    for d, times in parents.items():
        print(f"phase 4: --parent {d}: {times[0]}", flush=True)
    first = parents[args.parent[0]][0] if args.parent else None
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
    parent_k1 = first["dma_read_ms"] if first else None
    print(f"phase 4: K1 rows={rows} kernel_ms={kernel_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} "
          f"kernel_gbps={rows * 4096 / kernel_ms / 1e6:.1f} "
          f"bandwidth_call={bw.to_dict()} launches_per_call={per_call}"
          + (f" parent_ms={parent_k1}" if first else ""), flush=True)
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

    # 7-8. K2 against its plain version, then its times
    ring_err = check_ring(dev, rg)
    ring_times = time_ring(dev, rg, gen.hbm_gbps_per_chip, first)
    for d, times in parents.items():  # parent, tree, parent
        times.append(time_parent(d))
        print(f"phase 8: --parent {d} again: {times[1]}", flush=True)

    # 9. the multi-device path's entry points on one card, counts from 0
    ring_all_gather = rg.ring_all_gather
    ring_all_gather.launches = 0
    dma_read.launches = 0
    path = {f"ring_all_gather_correct_n{n}": port_ops.verify_ring_all_gather(ranks=n)
            for n in RING_RANKS}
    path["pallas_ring_n8"] = port_ops.bench_ring_all_gather(ranks=8).to_dict()
    path["ring_attention_correct"] = port_ops.verify_ring_attention()
    path["ring_attention_correct_noncausal"] = port_ops.verify_ring_attention(
        causal=False)
    path["ring_attention"] = port_ops.bench_ring_attention(
        seq_per_device=256, iters=4).to_dict()
    ring_launches = ring_all_gather.launches
    if not all(v is True for k, v in path.items() if "correct" in k):
        fail(f"multi-device path checks failed on one card: {path}")
    ra = path["ring_attention"]
    if not (math.isfinite(ra["tflops"]) and ra["tflops"] > 0
            and ra["time_per_iter_s"] > 0):
        fail(f"bench_ring_attention not finite and positive: {ra}")
    if ring_launches == 0:
        fail("the multi-device path did not launch K2")
    print(f"phase 9: verify_ring_all_gather(ranks=2,4,8) True; ring attention "
          f"verifies causal and not; bench_ring_attention {ra}; "
          f"K2 launched {ring_launches} times, K1 {dma_read.launches}",
          flush=True)

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 10. two processes, one card each, where there are two cards
    multi = multi_card(torch)

    # 11-12. the train path, counts from 0 (it runs no hand-written kernel)
    dma_read.launches = 0
    ring_all_gather.launches = 0
    gate_train = train_gate(koctl, psum_smoke)
    bench_train = train_bench(gen, smi)
    train_launches = dict(dma_read=dma_read.launches,
                          ring_all_gather=ring_all_gather.launches)
    print(f"phase 12: the train path launched K1 {train_launches['dma_read']} "
          f"and K2 {train_launches['ring_all_gather']} times (it runs neither)",
          flush=True)

    # 13. the tenant workload, counts from 0 (it runs no hand-written kernel)
    dma_read.launches = 0
    ring_all_gather.launches = 0
    workload = workload_bench(gen, smi)
    workload_launches = dict(dma_read=dma_read.launches,
                             ring_all_gather=ring_all_gather.launches)
    print(f"phase 13: the workload launched K1 {workload_launches['dma_read']} "
          f"and K2 {workload_launches['ring_all_gather']} times (it runs "
          f"neither)", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()

    # 14-16. the bench twin (K1's count from 0), the graft twin, the
    # multislice smoke and Ulysses
    bench_rec = bench_phase(gen, smi, dma_mod)
    if dist.is_initialized():
        dist.destroy_process_group()
    graft = graft_phase(dev)
    dcn_ulysses = dcn_ulysses_phase(dev)

    # 17. the verbs chain in subprocesses, counts from 0 here and there
    dma_read.launches = 0
    ring_all_gather.launches = 0
    torch.cuda.empty_cache()
    chain = workload_chain(smi)
    chain["launches_here"] = dict(dma_read=dma_read.launches,
                                  ring_all_gather=ring_all_gather.launches)

    # 18. the chaos soaks' device half and the perf_matrix rows, in
    # subprocesses, counts from 0 here and there
    dma_read.launches = 0
    ring_all_gather.launches = 0
    torch.cuda.empty_cache()
    drill = drill_phase(smi)
    drill["launches_here"] = dict(dma_read=dma_read.launches,
                                  ring_all_gather=ring_all_gather.launches)

    # 19. K3 on the card
    torch.cuda.empty_cache()
    k3 = attention_phase(smi)
    long = k3["shapes"]["6x8192x8x512"]

    # 20. K3 at latent attention's widths
    torch.cuda.empty_cache()
    latent = latent_attention_phase(smi, args.parent)
    n8 = ring_times["times"][8]
    forms = ["one card, virtual ranks"] + (["process per card"] if multi else [])
    kernels = {"kernels": [{
        "name": "dma_read", "route": "cuda",
        "source": "kubeoperator_tpu_torch/csrc/dma_read.cu",
        "replaces": "kubeoperator_tpu/ops/pallas_kernels.py:56",
        "launches": diag_launches, "bench_launches": bench_rec["k1_launches"],
        "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }, {
        "name": "ring_all_gather", "route": "cuda",
        "source": "kubeoperator_tpu_torch/csrc/ring_all_gather.cu",
        "replaces": "kubeoperator_tpu/ops/pallas_kernels.py:153",
        "launches": ring_launches, "max_abs_err": ring_err,
        "ms": n8["kernel_ms"], "plain_ms": n8["plain_ms"],
        "bound_ms": n8["bound_ms"], "bound_by": "bytes",
        "library_ms": n8["library_ms"], "host_forms": forms,
    }, {
        "name": "causal_attention", "route": "cuda",
        "source": "kubeoperator_tpu_torch/ops/attention.py",
        "replaces": None, "launches": workload["k3_launches"],
        "launches_per_train_step": workload["k3_launches"] / 12,
        "max_norm_err": max(e["norm"] for r in k3["shapes"].values()
                            for e in r["errors"].values()),
        "ms": long["fwd_ms"] + long["bwd_ms"],
        "plain_ms": fwd_and_bwd(long, "plain"),
        "bound_ms": long["fwd_bound_ms"] + long["bwd_bound_ms"],
        "bound_by": "operations",
        "library_ms": fwd_and_bwd(long, "library"),
    }]}
    record.update(kernels=kernels, diag=report, smoke=smoke,
                  parent_ms=parents,
                  launches_per_bandwidth_call=per_call,
                  bandwidth_call=bw.to_dict(), ring=ring_times,
                  multi_device_path=path, multi_card=multi,
                  train_gate=gate_train, train_bench=bench_train,
                  train_path_launches=train_launches, workload=workload,
                  workload_launches=workload_launches, bench=bench_rec,
                  graft=graft, dcn_ulysses=dcn_ulysses, workload_chain=chain,
                  drills=drill, attention=k3, latent_attention=latent,
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
