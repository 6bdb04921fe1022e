"""The sharded-training tenant workload: a (data, fsdp, tp) AdamW step
behind one compile seam (port of `workloads/step.py`).

`MODELS` is the one place a configuration's type picks its model module:
`NetConfig` the validation net's dense stage (`workloads/dense.py`),
`MlaMoeConfig` the DeepSeek-V3 block of Kimi K2 (`workloads/mla_moe.py`).
Both export the same seam (shapes, draw, batch, forward, loss, FLOPs,
rules, frozen leaves, lr, attention's widths); a new model is one more such
module and one more entry.

The reference writes the dense stage once in global-array form and lets
its compiler lay it out; the port runs each model as explicit SPMD on each
rank's blocks, in two modes with the reference's names:

* **pjit** (when the partition rules produced a spec tree, any spec
  tree the reference's `jax.jit` takes): every rank holds its blocks of
  the TrainState. A weight cut over a data axis (fsdp, or data) is
  all-gathered on use, and its gradient comes back reduce-scattered
  (`parallel/comm.py::all_gather`); the w_in / w_out pair cut on tp alone
  (w_in's columns, w_out's rows) runs Megatron-style (`replicate` in,
  `psum` out, as the validation net's FFN), and any other tp cut is
  gathered on use too, its gradient sliced back (tp ranks see the same
  batch); a gradient is then summed over each data axis its leaf is not
  cut on. AdamW is elementwise: each rank updates its own blocks, with
  each Adam moment re-cut to its parameter's layout for the update and
  back to its own after it.
* **shard_map** (no specs): parameters replicated, the batch sharded over
  (data, fsdp), the loss and every gradient summed there. tp ranks repeat
  the same work — the documented trade of the fallback.

The optimizer is AdamW as plain tensor functions in optax 0.2.6's order of
operations (`make_optimizer`), its state a tuple shaped like optax's
``(ScaleByAdamState(count, mu, nu), MaskedState(EmptyState()),
EmptyState())``, so the TrainState ``{"params", "opt"}`` has the
reference's 16 leaves under the reference's names and one rule list lays
out parameters and moments alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.parallel.comm import all_gather, psum
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec, mesh_device, mesh_sizes
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.utils.errors import ValidationError
from kubeoperator_tpu_torch.utils.spans import span
from kubeoperator_tpu_torch.weights import local_shard, spec_axes
from kubeoperator_tpu_torch.workloads import dense, mla_moe
from kubeoperator_tpu_torch.workloads.dense import ADAMW_LR
from kubeoperator_tpu_torch.workloads.mla_moe import MlaMoeConfig
from kubeoperator_tpu_torch.workloads.partition import (
    PartitionError,
    gather_leaf,
    make_shard_and_gather_fns,
    match_partition_rules,
    replicated_specs,
)

# the workload's mesh axes: data — batch parallelism; fsdp — batch AND
# parameter sharding (ZeRO-3 style); tp — tensor parallelism over the FFN
WORKLOAD_AXES = ("data", "fsdp", "tp")
# the axes that shard the batch (and join the loss/grad reductions)
DATA_AXES = ("data", "fsdp")
BATCH_SPEC = (DATA_AXES,)          # a batch's rows; its other dims whole

ADAMW_WEIGHT_DECAY = 1e-4
# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
_INT32_MAX = 2 ** 31 - 1

MODELS = {NetConfig: dense, MlaMoeConfig: mla_moe}
ModelConfig = NetConfig | MlaMoeConfig      # the keys of MODELS


def model_of(cfg):
    """The model module of a configuration (`MODELS`); ValidationError for
    a type with none."""
    if type(cfg) not in MODELS:
        raise ValidationError(f"no model for a {type(cfg).__name__}: the "
                              f"workload takes {tuple(t.__name__ for t in MODELS)}")
    return MODELS[type(cfg)]


def default_rules(cfg=None):
    """The workload's layout as ordered (regex, spec) rules: the model's
    own (the dense stage's without a `cfg`)."""
    return model_of(cfg or NetConfig()).default_rules()


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """An abstract leaf: what the rule engine and the checkpoint template
    consult without materializing a weight."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class ScaleByAdamState(NamedTuple):
    count: object
    mu: object
    nu: object


class EmptyState(NamedTuple):
    pass


class MaskedState(NamedTuple):
    inner_state: object


def _opt_state(count, mu, nu) -> tuple:
    """optax.adamw's state: the Adam moments, then the (masked) weight
    decay's and the learning-rate scale's empty states."""
    return (ScaleByAdamState(count=count, mu=mu, nu=nu),
            MaskedState(inner_state=EmptyState()), EmptyState())


def param_shapes(cfg: ModelConfig | None = None) -> dict:
    """Abstract param tree, in the model's draw order."""
    cfg = cfg or NetConfig()
    return {name: ShapeDtypeStruct(shape, dt)
            for name, (shape, dt) in model_of(cfg).param_shapes(cfg).items()}


def build_host_params(cfg: ModelConfig | None = None, seed: int = 0) -> dict:
    """Param tree as CPU tensors, drawn as the model draws them."""
    cfg = cfg or NetConfig()
    return model_of(cfg).init_params(cfg, seed, "cpu")


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the reference's weak-typed constant: rounded to
    `like`'s type first. A 0-d CPU tensor, which a CUDA kernel takes as an
    argument (no copy to the card)."""
    return torch.tensor(value, dtype=like.dtype)


@dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr, weight_decay=ADAMW_WEIGHT_DECAY, mask=ndim > 0) with
    optax's defaults, as tensor functions, operation for operation in optax
    0.2.6's order (`scale_by_adam`, `tree_update_moment`,
    `tree_bias_correction`, `add_decayed_weights`, `scale_by_learning_rate`,
    `apply_updates`): the moments stay in the parameter's type, each Python
    constant is rounded to the leaf's type before it is used, and the bias
    correction ``1 - b**count`` is formed in f32 and cast to the moment's
    type before the divide."""

    lr: float = ADAMW_LR

    def init(self, params: dict) -> tuple:
        step = params["step"]
        return _opt_state(
            torch.zeros((), dtype=torch.int32, device=step.device),
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: dict, state: tuple, params: dict):
        """(updates, new_state) for `grads`, as optax's `update`."""
        adam = state[0]
        count = torch.where(adam.count < _INT32_MAX, adam.count + 1, adam.count)
        count_f = count.to(torch.float32)
        bc1 = 1 - torch.full_like(count_f, ADAM_B1) ** count_f
        bc2 = 1 - torch.full_like(count_f, ADAM_B2) ** count_f
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = _const(1 - ADAM_B1, g) * g + _const(ADAM_B1, g) * adam.mu[k]
            nu[k] = _const(1 - ADAM_B2, g) * (g * g) + _const(ADAM_B2, g) * adam.nu[k]
            mu_hat = mu[k] / bc1.to(mu[k].dtype)
            nu_hat = nu[k] / bc2.to(nu[k].dtype)
            u = mu_hat / (torch.sqrt(nu_hat + _const(ADAM_EPS_ROOT, g))
                          + _const(ADAM_EPS, g))
            p = params[k]
            if p.dim() > 0:      # weight decay is masked off 0-d leaves
                u = u + _const(ADAMW_WEIGHT_DECAY, u) * p
            updates[k] = _const(-self.lr, u) * u
        return updates, _opt_state(count, mu, nu)


def apply_updates(params: dict, updates: dict) -> dict:
    """optax.apply_updates: ``(p + u)`` in p's type."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def make_optimizer(lr: float | None = None) -> AdamW:
    """THE workload optimizer, built in one place so the step, the
    state-shape derivation and checkpoint restore agree on its state."""
    return AdamW(lr=ADAMW_LR if lr is None else lr)


def adamw_lr(cfg: ModelConfig) -> float:
    """The configuration's AdamW learning rate (the model's `adamw_lr`)."""
    return model_of(cfg).adamw_lr(cfg)


def frozen_leaves(cfg: ModelConfig) -> tuple[str, ...]:
    """The leaves of the param tree no gradient moves (the model's)."""
    return model_of(cfg).frozen(cfg)


def train_state_shapes(cfg: ModelConfig | None = None) -> dict:
    """Abstract TrainState tree ``{"params", "opt"}``: the Adam moments
    carry the params' names (matched by the same rules), and `opt/0/count`
    is a 0-d int32 leaf the scalar exemption claims."""
    params = param_shapes(cfg)
    return {"params": params,
            "opt": _opt_state(ShapeDtypeStruct((), torch.int32),
                              dict(params), dict(params))}


def build_host_state(cfg: ModelConfig | None = None, seed: int = 0) -> dict:
    """Host TrainState: seeded params + the optimizer's zero state."""
    params = build_host_params(cfg, seed)
    return {"params": params, "opt": make_optimizer().init(params)}


def init_train_state(mesh: DeviceMesh, cfg: ModelConfig | None = None,
                     seed: int = 0, specs=None) -> dict:
    """TrainState drawn for the mesh's device and placed onto `mesh`: this
    rank's blocks per the spec tree (pjit), the whole of it otherwise
    (shard_map)."""
    cfg = cfg or NetConfig()
    params = model_of(cfg).init_params(cfg, seed, mesh_device(mesh))
    host = {"params": params, "opt": make_optimizer().init(params)}
    if specs is None:
        specs = replicated_specs(host)
    shard_fn, _ = make_shard_and_gather_fns(mesh, specs)
    return shard_fn(host)


def build_batch(mesh: DeviceMesh, cfg: ModelConfig | None = None,
                seed: int = 1) -> torch.Tensor:
    """This rank's block of the model's global batch of b_local·data·fsdp
    rows ([rows, seq, d_model] inputs, or [rows, seq + 1] token ids), cut
    over the (data, fsdp) axes. Weak scaling on the batch axes: the
    per-rank batch stays `cfg.b_local` whatever the mesh shape."""
    cfg = cfg or NetConfig()
    sizes = mesh_sizes(mesh)
    host = model_of(cfg).host_batch(
        cfg, cfg.b_local * sizes["data"] * sizes["fsdp"], seed)
    return local_shard(host, BATCH_SPEC, mesh).to(mesh_device(mesh))


def analytic_step_flops(mesh: DeviceMesh | MeshSpec,
                        cfg: ModelConfig | None = None) -> float:
    """Model FLOPs for one global step from the architecture alone: the
    model's `step_flops` over the global batch's tokens."""
    cfg = cfg or NetConfig()
    sizes = mesh_sizes(mesh)
    tokens = cfg.b_local * sizes["data"] * sizes["fsdp"] * cfg.s_local
    return model_of(cfg).step_flops(cfg, tokens)


def _flat_axes(spec) -> tuple[str, ...]:
    return tuple(a for entry in spec for a in spec_axes(entry))


def check_workload_mesh(mesh: DeviceMesh | MeshSpec, what: str) -> dict[str, int]:
    """The mesh's {axis: length}; PartitionError unless it carries every
    workload axis (`what` names the caller in the message)."""
    sizes = mesh_sizes(mesh)
    for axis in WORKLOAD_AXES:
        if axis not in sizes:
            raise PartitionError(
                f"{what} mesh must carry the {WORKLOAD_AXES} axes, "
                f"got {tuple(sizes)}")
    return sizes


def check_attention_width(mesh: DeviceMesh, cfg: ModelConfig) -> None:
    """ValidationError for a bf16 config on a card whose head widths the
    fused attention is not built for (the model's `attention_unbuilt`),
    when the step or forward is built rather than at its first call."""
    if cfg.dtype != "bfloat16" or mesh.device_type != "cuda":
        return
    why = model_of(cfg).attention_unbuilt(cfg)
    if why:
        raise ValidationError(f"a bfloat16 run on a card takes {why}")


def resolve_mode(mode: str, specs) -> str:
    """The compile mode that runs: ``auto`` is pjit when specs exist, else
    shard_map; PartitionError for pjit without specs or another name."""
    if mode == "auto":
        return "pjit" if specs is not None else "shard_map"
    if mode == "pjit" and specs is None:
        raise PartitionError(
            "compile mode 'pjit' needs explicit shardings — run the "
            "partition rules first, or use mode 'shard_map'")
    if mode not in ("pjit", "shard_map"):
        raise PartitionError(
            f"unknown compile mode {mode!r} (auto|pjit|shard_map)")
    return mode


# the Megatron pair: w_in's columns and w_out's rows cut on tp
_PAIR = {"w_in": 1, "w_out": 0}


def _cut(spec, dim: int) -> tuple[str, ...]:
    return spec_axes(spec[dim]) if dim < len(spec) else ()


def megatron_pair(param_specs: dict) -> bool:
    """Whether the params' spec tree runs the FFN Megatron-style: w_in's
    columns and w_out's rows cut on tp alone."""
    return all(name in param_specs and _cut(param_specs[name], dim) == ("tp",)
               for name, dim in _PAIR.items())


def gather_on_use(p: dict, param_specs: dict, groups: dict,
                  megatron: bool) -> dict:
    """Whole weights from this rank's blocks: every cut dim all-gathered
    over its axes, minor axis first, except the Megatron pair's tp cuts
    when `megatron`. A data axis's gather sums the cotangent in backward
    (its ranks see different batches); a tp gather keeps this rank's block
    of it (tp ranks see the same batch, so each has the whole gradient)."""
    out = {}
    for name, w in p.items():
        for dim, entry in enumerate(param_specs[name]):
            for axis in reversed(spec_axes(entry)):
                if axis == "tp" and megatron and _PAIR.get(name) == dim:
                    continue
                w = all_gather(w, dim, groups[axis], sum_grad=axis != "tp")
        out[name] = w
    return out


def relayout(t: torch.Tensor, src, dst, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a leaf laid out as `src`, re-cut as `dst`."""
    if tuple(src) == tuple(dst):
        return t
    return local_shard(gather_leaf(t, src, mesh), dst, mesh)


def compile_step(mesh: DeviceMesh, cfg: ModelConfig | None = None,
                 specs=None, mode: str = "auto", lr: float | None = None):
    """THE compile seam: returns ``(step_fn, used)`` where
    ``step_fn(state, x) -> (loss, new_state)`` over the TrainState tree
    ``{"params", "opt"}`` of this rank's blocks and ``used`` is the mode
    that runs. ``specs`` is the TrainState spec tree from the partition
    rules. ``mode`` is ``auto`` (pjit when specs exist, else shard_map), or
    a forced ``pjit`` / ``shard_map``. ``lr`` is AdamW's learning rate
    (default: the configuration's, `adamw_lr`). Every rank of the mesh
    calls `step_fn` together."""
    cfg = cfg or NetConfig()
    model = model_of(cfg)
    optimizer = make_optimizer(model.adamw_lr(cfg) if lr is None else lr)
    sizes = check_workload_mesh(mesh, "workload")
    check_attention_width(mesh, cfg)
    if specs is not None and (not isinstance(specs, dict)
                              or set(specs) != {"params", "opt"}):
        raise PartitionError(
            "compile_step shards the full TrainState: specs must be the "
            "{'params', 'opt'} tree from "
            "match_partition_rules(rules, train_state_shapes()) — a "
            "params-only spec tree leaves the optimizer state unlaid-out")
    mode = resolve_mode(mode, specs)
    denom = model.loss_count(cfg, cfg.b_local * sizes["data"] * sizes["fsdp"])
    if mode == "pjit":
        pspecs = specs["params"]
        moment_specs = specs["opt"][0]
        megatron = megatron_pair(pspecs)
    else:
        pspecs, moment_specs, megatron = None, None, False
    groups = {a: mesh.get_group(a) for a in WORKLOAD_AXES}
    data_groups = [groups[a] for a in DATA_AXES if sizes[a] > 1]
    fixed = model.frozen(cfg)
    trainable = [k for k in model.param_shapes(cfg) if k not in fixed]

    def sum_axes(name: str) -> list:
        """Data axes whose ranks' gradients of `name` are summed after
        backward: in pjit those the leaf is not cut on (a cut one was summed
        by the gather's backward), in shard_map all of them."""
        if pspecs is None:
            return data_groups
        cut = _flat_axes(pspecs[name])
        return [groups[a] for a in DATA_AXES if a not in cut and sizes[a] > 1]

    def loss_and_grads(params: dict, x: torch.Tensor):
        p = {k: params[k].detach().requires_grad_() for k in trainable}
        p.update({k: params[k] for k in fixed if k != "step"})
        whole = (gather_on_use(p, pspecs, groups, megatron)
                 if pspecs is not None else p)
        loss = model.loss_sum(whole, x, cfg,
                              groups["tp"] if megatron else None) / denom
        if pspecs is not None:
            for g in data_groups:
                loss = psum(loss, g)
        grads = torch.autograd.grad(loss, [p[k] for k in trainable])
        loss = loss.detach()
        if pspecs is None:
            for g in data_groups:
                dist.all_reduce(loss, group=g)
        out = {}
        for k, g in zip(trainable, grads):
            for group in sum_axes(k):
                dist.all_reduce(g, group=group)
            out[k] = g
        for k in fixed:
            out[k] = torch.zeros_like(params[k])
        return loss, out

    def lay_moments(opt: tuple, as_params: bool) -> tuple:
        """The Adam moments re-cut to their params' layouts for the
        elementwise update (`as_params`), or back to their own."""
        adam = opt[0]
        moved = []
        for moments, own in ((adam.mu, moment_specs.mu),
                             (adam.nu, moment_specs.nu)):
            moved.append({k: relayout(t, *((own[k], pspecs[k]) if as_params
                                           else (pspecs[k], own[k])), mesh)
                          for k, t in moments.items()})
        return _opt_state(adam.count, *moved)

    def step_fn(state: dict, x: torch.Tensor):
        params = state["params"]
        loss, grads = loss_and_grads(params, x)
        with torch.no_grad(), span("step.optimizer"):
            grads = {k: grads[k] for k in params}
            opt = state["opt"]
            if pspecs is not None:
                opt = lay_moments(opt, as_params=True)
            updates, new_opt = optimizer.update(grads, opt, params)
            if pspecs is not None:
                new_opt = lay_moments(new_opt, as_params=False)
            new_p = apply_updates(params, updates)
            for k in fixed:
                if k != "step":
                    new_p[k] = params[k]
            # the counter rides outside the gradient flow; written last, so a
            # read of it waits for the whole step
            new_p["step"] = params["step"] + 1.0
        return loss, {"params": new_p, "opt": new_opt}

    return step_fn, mode


def make_train_step(mesh: DeviceMesh, cfg: ModelConfig | None = None,
                    rules=None, mode: str = "auto", lr: float | None = None):
    """Rules → TrainState specs → step, in one call: returns
    ``(step_fn, specs_or_None, used_mode)``; `specs` is None exactly when
    the shard_map fallback runs."""
    cfg = cfg or NetConfig()
    if mode == "shard_map":
        specs = None
    else:
        specs = match_partition_rules(
            rules if rules is not None else default_rules(cfg),
            train_state_shapes(cfg))
    step, used = compile_step(mesh, cfg, specs=specs, mode=mode, lr=lr)
    return step, None if used == "shard_map" else specs, used

