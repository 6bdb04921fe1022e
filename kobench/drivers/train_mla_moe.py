"""The training window of the tenant workload's entry,
`kubeoperator_tpu_torch/workloads/harness.py::run_training`, on the Kimi-K2
block (`workloads/mla_moe.py`).

The run is `train_dense`'s, with this model: one call of the entry, handed
a TrainState made on the device from the seed (``state=``), feeding its own
batch of token ids (numpy's draw from ``seed + 1``, the same every step).
Its first `checked` steps are set-up: the Adam moment after step 1 and the
weights after the last checked step are copied to the host. The window
then runs to the first step boundary past ``seconds``; the entry's own
fence waits for the last update. The expert layer's slot counter is reset
when the window opens and read once after it.

When traced, the trace is also put down to the port's ``ko.*`` spans
(`kobench/spans.py`) and K3's kernels are timed by name. Then the plain
reference (`kobench/reference/kimi_k2.py`) repeats the checked steps from
the same weights, made again from the seed, once the program's state is
freed from the card.
"""

from __future__ import annotations

import importlib
import math
import sys
import time

import torch

from kobench import compare, faults, flops_mla, inputs, peaks
from kobench import spans as spanning
from kobench import trace as tracing
from kobench.drivers.train_dense import _device, _profiler, _sync, _to_host
from kobench.reference import kimi_k2, precision

# K3's kernels, by the names the trace gives them
K3_KERNELS = ("attention_kernel", "delta_kernel")


def _port(name: str):
    """A module of the port, loaded by name (kobench/tests/
    test_kobench_layout.py lists the files that import it by statement)."""
    return importlib.import_module("kubeoperator_tpu_torch." + name)


def model_config(cfg: dict):
    """The port's `MlaMoeConfig` of a configuration file."""
    return _port("workloads.mla_moe").MlaMoeConfig(**vars(kimi_k2.dims(cfg)))


def _initial_state(cell, seed: int, dev) -> dict:
    """The TrainState the entry starts from; only the entry holds it."""
    params = dict(kimi_k2.weights(cell.config, seed, dev),
                  step=torch.zeros((), dtype=torch.float32, device=dev))
    return {"params": params,
            "opt": _port("workloads.step").make_optimizer().init(params)}


def _k3(device_events) -> tuple[float, list]:
    """Device seconds of K3's kernels and their names."""
    mine = [e for e in device_events if any(k in e.name for k in K3_KERNELS)]
    return (sum(e.end_ns - e.start_ns for e in mine) / 1e9,
            sorted({e.name for e in mine}))


def _spans(layer: dict, prof) -> None:
    """The trace put down to the port's spans, as `train_dense_spans` does,
    and each span's times a step on standard error."""
    summary = spanning.summarize(*spanning.from_profiler(prof))
    layer["spans"] = summary
    layer["trace"]["idle_gaps"] = summary["idle_gaps"]
    steps = max(layer["steps"], 1)
    for name, s in sorted(summary["spans"].items()):
        print(f"kobench: span {name} device {1e3 * s['device_s'] / steps!r} "
              f"ms/step host {1e3 * s['host_s'] / steps!r} ms/step "
              f"of which runtime calls {1e3 * s['runtime_s'] / steps!r} "
              f"blocked {1e3 * s['blocked_s'] / steps!r} "
              f"count {s['count']}", file=sys.stderr)
    print(f"kobench: span none device "
          f"{1e3 * summary['unclaimed_s'] / steps!r} ms/step of busy "
          f"{1e3 * summary['busy_s'] / steps!r}", file=sys.stderr)


def program_run(cell, seed: int, seconds: float, trace: bool, device: str,
                fault: str | None = None) -> tuple[dict, dict]:
    """The entry's run: (outcome without readings, the program's outputs,
    on the host)."""
    harness = _port("workloads.harness")
    loads = _port("workloads.mla_moe").expert_loads
    cfg_d = cell.config
    checked = int(cell.traffic["checked_steps"])
    dev = _port("parallel.multislice").initialize_from_env(device)
    cfg = model_config(cfg_d)
    mesh = _port("parallel.mesh").MeshSpec(
        axes=tuple(cfg_d["mesh"].items())).build(dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    kept: dict = {"losses": []}
    clock: dict = {}
    prof = _profiler(dev.type) if trace else None

    def on_step(done: int, loss) -> bool:
        if done <= checked:
            kept["losses"].append(loss)
            return False
        return time.perf_counter() >= clock["deadline"]

    def on_checkpoint(done: int, st) -> None:
        if done == 1:
            kept["mu1"] = _to_host(st["opt"][0].mu)
        if done == checked:
            kept["last"] = _to_host(st["params"])
            if prof is not None:      # the profiler's own start-up is set-up
                prof.start()
            _sync(dev)
            loads.reset()
            clock["wall"] = time.time()
            clock["start"] = time.perf_counter()
            clock["deadline"] = clock["start"] + seconds

    with faults.plant("train_dense", fault):
        record = harness.run_training(
            mesh, cfg, steps=10 ** 9, state=_initial_state(cell, seed, dev),
            seed=seed,
            on_step=on_step, checkpoint_every=1, on_checkpoint=on_checkpoint)
    _sync(dev)
    window_s = time.perf_counter() - clock["start"]
    if prof is not None:
        prof.stop()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counted = loads.read()

    steps = record["steps"] - checked
    tokens = kimi_k2.global_batch(cfg_d) * cfg_d["s_local"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    layer = {"steps": steps, "window_s": window_s, "chips": cell.chips,
             "step_flops": flops_mla.step_flops(cfg_d),
             "k3_operations": flops_mla.k3_operations(cfg_d),
             "peak_flops": peaks.bf16_flops(kind),
             "expert_loads": counted.tolist() if counted is not None else None}
    if prof is not None:
        events = tracing.from_profiler(prof)
        layer["trace"] = tracing.summarize(*events)
        layer["k3_s"], names = _k3(events[0])
        print(f"kobench: K3 kernels {names}", file=sys.stderr)
        _spans(layer, prof)
    print(f"kobench: expert loads {layer['expert_loads']}", file=sys.stderr)
    outcome = {"window_start": clock["wall"],
               "e2e": {"train_tokens_per_s": steps * tokens / window_s},
               "layer": layer, "attempted": steps,
               "failed": sum(not math.isfinite(x) for x in record["losses"]),
               "kind": kind, "memory_peak_bytes": memory}

    # the program's outputs, on the host: each checked step's loss, the
    # first gradient from the Adam state after step 1 (mu_1 = (1 - b1) g_1,
    # the constant rounded to the state's type as the optimizer rounds it),
    # the change of every weight after the checked steps
    del record
    b1 = cfg_d["optimizer"]["b1"]
    one_minus_b1 = float(torch.tensor(1 - b1, dtype=inputs.DTYPES[cfg_d["dtype"]]))
    p0 = kimi_k2.weights(cfg_d, seed, dev)
    mu1, last = kept["mu1"], kept["last"]
    prog = {"losses": [float(x) for x in kept["losses"]],
            "grad1": {k: mu1[k].float() / one_minus_b1
                      for k in p0 if not kimi_k2.frozen(k)},
            "change": {k: (last[k].to(dev).float() - p0[k].float()).cpu()
                       for k in p0}}
    return outcome, prog


def reference_outputs(cell, seed: int, device, mode: str = "f32") -> dict:
    """The reference's checked steps from the same weights and ids, in
    precision `mode` (``fp8``: the control), on `device`."""
    cfg_d = cell.config
    p0 = kimi_k2.weights(cfg_d, seed, device)
    ids = kimi_k2.entry_batch(cfg_d, seed, device)
    out = kimi_k2.train_steps(p0, ids, cfg_d, int(cell.traffic["checked_steps"]),
                              precision.product(mode))
    change = {k: out["params"][k] - p0[k].float() for k in p0}
    del out["params"], p0
    return {"losses": out["losses"],
            "grad1": {k: g.to(device) for k, g in out["grad1"].items()},
            "change": change}


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: str | None = None) -> dict:
    outcome, prog = program_run(cell, seed, seconds, trace, device, fault)
    outcome["readings"] = compare.train_readings(
        prog, reference_outputs(cell, seed, _device(device)))
    return outcome


def control(cell, seed: int, device: str = "cuda") -> dict:
    """The control's readings: the reference in fp8 put in the program's
    place, held against the reference in float32."""
    dev = _device(device)
    low = reference_outputs(cell, seed, dev, "fp8")
    low = {"losses": low["losses"],
           **{k: {n: t.cpu() for n, t in low[k].items()}
              for k in ("grad1", "change")}}
    return compare.train_readings(low, reference_outputs(cell, seed, dev))
