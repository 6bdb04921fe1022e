"""The serving window of the tenant workload: the forward that
`kubeoperator_tpu_torch/workloads/serve.py::make_forward` returns, plus the
serve verb's answer read (`serve._digest`), under open-loop arrivals.

A request is one [global batch, seq, d_model] batch, taken from a pool of
`pool` batches made on the device from the seed. Arrivals are one fixed
sample of a Poisson stream at ``rate_per_s`` (the traffic file's
``arrival_seed``), drawn as the stream is given its count: rate × seconds
arrival times, uniform over the window. Every seed so offers the same
load at the stated rate; the seed draws the weights, the pool and which
pool batch each request carries, and which answers and rows of them the
check keeps. One request is served at a time, in arrival order. A request's latency runs
from the moment it was due to the moment its answer was read on the host,
so queueing counts. The window takes every request due within
``seconds`` and closes when the last of them is answered.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from kobench import compare, faults, flops, inputs, peaks, trace as tracing
from kobench.drivers.train_dense import (_device, _net_config, _profiler,
                                         _reference, _sync)
from kobench.reference import precision

SPAN = "kobench.request"


def arrivals(rate_per_s: float, seconds: float, arrival_seed: int) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream of
    round(rate × seconds) arrivals in the window."""
    rng = np.random.default_rng(arrival_seed)
    return np.sort(rng.uniform(0.0, seconds, size=round(rate_per_s * seconds)))


def serve_open_loop(forward, params, pool: list, due: np.ndarray,
                    which: np.ndarray, read, keep=(), rows=(),
                    annotate: bool = False):
    """Serve request i (pool batch ``which[i]``) at ``due[i]``; returns
    (start wall time, per-request latency s, service s, answers read,
    {i: (shape of the output, its rows `rows`)} for i in `keep`)."""
    latency, service, answers, kept = [], [], [], {}
    wall, t0 = time.time(), time.perf_counter()
    for i, at in enumerate(due):
        target = t0 + at
        while True:
            gap = target - time.perf_counter()
            if gap <= 0:
                break
            if gap > 2e-3:
                time.sleep(gap - 1e-3)
        begin = time.perf_counter()
        if annotate:
            with torch.profiler.record_function(SPAN):
                y = forward(params, pool[which[i]])
                answer = read(y)
        else:
            y = forward(params, pool[which[i]])
            answer = read(y)
        done = time.perf_counter()
        latency.append(done - target)
        service.append(done - begin)
        answers.append(answer)
        if i in keep:
            kept[i] = (tuple(y.shape), y[[r for r in rows if r < len(y)]])
    return wall, latency, service, answers, kept


def _setup(cell, seed: int, device: str, fault):
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.workloads import serve
    from kubeoperator_tpu_torch.workloads.partition import (
        make_shard_and_gather_fns, replicated_specs)

    cfg_d = cell.config
    dev = initialize_from_env(device)
    mesh = MeshSpec(axes=tuple(cfg_d["mesh"].items())).build(dev.type)
    with faults.plant("serve_dense", fault):
        forward, specs, _ = serve.make_forward(mesh, _net_config(cfg_d))
    pool, weights = _inputs(cell, seed, dev)
    params = dict(weights, step=torch.zeros((), dtype=torch.float32, device=dev))
    shard_fn, _ = make_shard_and_gather_fns(
        mesh, specs if specs is not None else replicated_specs(params))
    placed = shard_fn(params)

    def read(y):
        return serve._digest(y, mesh)

    return dev, forward, placed, pool, weights, read


def _inputs(cell, seed: int, device):
    """(request pool, weights) of `seed` on `device`."""
    cfg_d = cell.config
    ref = _reference(cell)
    gen = inputs.generator(seed, device)
    dtype = inputs.DTYPES[cfg_d["dtype"]]
    params = inputs.normal_tree(ref.weight_shapes(cfg_d), gen, dtype,
                                cfg_d["init_scale"])
    shape = (ref.global_batch(cfg_d), cfg_d["s_local"], cfg_d["d_model"])
    pool = [inputs.normal(shape, gen, dtype) for _ in range(cell.traffic["pool"])]
    return pool, params


def _rows(cell, seed: int) -> list:
    """The rows (whole sequences) of each sampled answer that the check
    keeps, drawn from the seed."""
    n = _reference(cell).global_batch(cell.config)
    rng = np.random.default_rng([seed, 1])
    return sorted(rng.choice(n, size=min(cell.traffic["rows"], n),
                             replace=False).tolist())


def _schedule(cell, seed: int, seconds: float):
    tr = cell.traffic
    due = arrivals(tr["rate_per_s"], seconds, tr["arrival_seed"])
    rng = np.random.default_rng(seed)
    which = rng.integers(0, tr["pool"], size=len(due))
    keep = set(rng.choice(len(due), size=min(tr["sampled"], len(due)),
                          replace=False).tolist()) if len(due) else set()
    return due, which, keep


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: str | None = None) -> dict:
    cfg_d = cell.config
    dev, forward, placed, pool, weights, read = _setup(cell, seed, device, fault)
    for batch in pool:                       # the cell's one shape, warmed
        read(forward(placed, batch))
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    due, which, keep = _schedule(cell, seed, seconds)
    rows = _rows(cell, seed)
    prof = _profiler(dev.type) if trace else None
    if prof is not None:              # the profiler's own start-up is set-up
        prof.start()
        _sync(dev)
    wall, latency, service, answers, kept = serve_open_loop(
        forward, placed, pool, due, which, read, keep, rows, annotate=trace)
    _sync(dev)
    window_s = time.time() - wall
    if prof is not None:
        prof.stop()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    layer = {"service_s": service, "window_s": window_s,
             "forward_flops": flops.dense_forward_flops(cfg_d, cfg_d["mesh"]),
             "peak_flops": peaks.bf16_flops(kind)}
    if prof is not None:
        layer["trace"] = tracing.summarize(
            *tracing.from_profiler(prof, annotation=SPAN))
    outcome = {"window_start": wall,
               "e2e": {"serve_p95_ms": float(np.percentile(latency, 95)) * 1e3
                       if latency else math.inf},
               "layer": layer, "attempted": len(due),
               "failed": sum(not math.isfinite(a) for a in answers),
               "kind": kind, "memory_peak_bytes": memory}
    del placed, forward
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    outcome["readings"] = _check(cell, weights, pool, which, answers, kept, rows)
    return outcome


def _check(cell, weights, pool, which, answers, kept, rows) -> dict:
    """Every answer's digest against the reference's digest of its batch,
    and the kept rows of each sampled answer token by token against the
    reference's."""
    ref = _reference(cell)
    mm = precision.product("f32")
    digest_err, token_err = 0.0, 0.0
    for j, batch in enumerate(pool):
        y_ref = ref.serve(weights, batch, cell.config, mm)
        d_ref = compare.digest(y_ref)
        for i in np.flatnonzero(which == j):
            a = answers[i]
            digest_err = max(digest_err, abs(a - d_ref) / d_ref
                             if math.isfinite(a) else math.inf)
            if i in kept:
                shape, got = kept.pop(i)
                token_err = max(token_err,
                                compare.token_err(shape, got, y_ref, rows))
        del y_ref
    return {"digest_err": digest_err, "token_err": token_err}


def control(cell, seed: int, device: str = "cuda") -> dict:
    """The control's readings: the reference in fp8 answering every pool
    batch in the program's place, held against the reference in float32
    (token by token on the rows the program's check keeps)."""
    dev = _device(device)
    pool, weights = _inputs(cell, seed, dev)
    rows = _rows(cell, seed)
    ref = _reference(cell)
    low, f32 = precision.product("fp8"), precision.product("f32")
    digest_err, token_err = 0.0, 0.0
    for batch in pool:
        y_ref = ref.serve(weights, batch, cell.config, f32)
        y_low = ref.serve(weights, batch, cell.config, low)
        d_ref = compare.digest(y_ref)
        digest_err = max(digest_err, abs(compare.digest(y_low) - d_ref) / d_ref)
        token_err = max(token_err, compare.token_err(y_low.shape, y_low[rows],
                                                     y_ref, rows))
        del y_ref, y_low
    return {"digest_err": digest_err, "token_err": token_err}
