"""The training window of the tenant workload's entry,
`kubeoperator_tpu_torch/workloads/harness.py::run_training`.

One call of the entry is the whole run. The benchmark hands it a TrainState
made on the device from the seed (``state=``); the entry feeds its own
batch (numpy's draw from ``seed + 1``, the same every step). Its first
`checked` steps are set-up: step 1 warms up, and the Adam moment after
step 1 and the weights after the last checked step are copied to the host
for the check, so the card holds only the program's own state. Then the
window opens, and an ``on_step`` hook stops the entry at the first step
boundary past ``seconds``; the entry's own fence waits for the last
update. The reference then repeats the checked steps from the same
weights, made again from the seed.
"""

from __future__ import annotations

import math
import time

import torch

from kobench import compare, faults, flops, inputs, peaks, trace as tracing
from kobench.reference import precision


def _net_config(cfg: dict):
    """The port's `NetConfig` of a configuration file (the dense stage
    takes its optimizer from `workloads/step.py` and reads no lr or remat)."""
    from kubeoperator_tpu_torch.parallel.validation_net import NetConfig

    return NetConfig(d_model=cfg["d_model"], d_ff=cfg["d_ff"],
                     heads=cfg["heads"], b_local=cfg["b_local"],
                     s_local=cfg["s_local"], dtype=cfg["dtype"],
                     lr=cfg["optimizer"]["lr"], remat=cfg["remat"])


def _reference(cell):
    import importlib

    return importlib.import_module(f"kobench.reference.{cell.config['reference']}")


def _profiler(device: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, with_flops=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device(device: str) -> torch.device:
    """The current CUDA card for "cuda", else `device`; the program's state
    freed from the card's cache before the reference runs there."""
    if device != "cuda":
        return torch.device(device)
    torch.cuda.empty_cache()
    return torch.device("cuda", torch.cuda.current_device())


def _weights(cell, seed: int, device) -> dict:
    """The initial weights of `seed` on `device`."""
    cfg_d = cell.config
    return inputs.normal_tree(_reference(cell).weight_shapes(cfg_d),
                              inputs.generator(seed, device),
                              inputs.DTYPES[cfg_d["dtype"]], cfg_d["init_scale"])


def _initial_state(cell, seed: int, dev) -> dict:
    """The TrainState the entry starts from; only the entry holds it."""
    from kubeoperator_tpu_torch.workloads import step as wstep

    params = dict(_weights(cell, seed, dev),
                  step=torch.zeros((), dtype=torch.float32, device=dev))
    return {"params": params, "opt": wstep.make_optimizer().init(params)}


def _to_host(tree: dict) -> dict:
    return {k: v.to("cpu") for k, v in tree.items()}


def program_run(cell, seed: int, seconds: float, trace: bool, device: str,
                fault: str | None = None) -> tuple[dict, dict]:
    """The entry's run: (outcome without readings, the program's outputs)."""
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.workloads import harness

    cfg_d = cell.config
    checked = int(cell.traffic["checked_steps"])
    dev = initialize_from_env(device)
    cfg = _net_config(cfg_d)
    mesh = MeshSpec(axes=tuple(cfg_d["mesh"].items())).build(dev.type)
    dtype = inputs.DTYPES[cfg_d["dtype"]]
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

    steps = record["steps"] - checked
    tokens = cfg_d["b_local"] * cfg_d["mesh"]["data"] * cfg_d["mesh"]["fsdp"] \
        * cfg_d["s_local"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    layer = {"steps": steps, "window_s": window_s, "chips": cell.chips,
             "step_flops": flops.dense_step_flops(cfg_d, cfg_d["mesh"]),
             "peak_flops": peaks.bf16_flops(kind)}
    if prof is not None:
        layer["trace"] = tracing.summarize(*tracing.from_profiler(prof))
    outcome = {"window_start": clock["wall"],
               "e2e": {"train_tokens_per_s": steps * tokens / window_s},
               "layer": layer, "attempted": steps,
               "failed": sum(not math.isfinite(x) for x in record["losses"]),
               "kind": kind, "memory_peak_bytes": memory}

    # the program's outputs: each checked step's loss, the first gradient
    # from the Adam state after step 1 (mu_1 = (1 - b1) g_1, the constant
    # rounded to the state's type as the optimizer rounds it), the change
    # of every weight after the checked steps
    b1 = cfg_d["optimizer"]["b1"]
    one_minus_b1 = float(torch.tensor(1 - b1, dtype=dtype))
    del record
    p0 = _weights(cell, seed, dev)
    mu1, last = kept["mu1"], kept["last"]
    prog = {"losses": [float(x) for x in kept["losses"]],
            "grad1": {k: mu1[k].float() / one_minus_b1 for k in p0},
            "change": {k: last[k].to(dev).float() - p0[k].float() for k in p0}}
    return outcome, prog


def reference_outputs(cell, seed: int, device, mode: str = "f32") -> dict:
    """The reference's checked steps from the same weights and batch, in
    precision `mode` (``fp8``: the control)."""
    cfg_d = cell.config
    ref = _reference(cell)
    p0 = _weights(cell, seed, device)
    x = ref.entry_batch(cfg_d, seed, device)
    out = ref.train_steps(p0, x, cfg_d, int(cell.traffic["checked_steps"]),
                          precision.product(mode))
    return {"losses": out["losses"], "grad1": out["grad1"],
            "change": {k: out["params"][k] - p0[k].float() for k in p0}}


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
    return compare.train_readings(low, reference_outputs(cell, seed, dev))
