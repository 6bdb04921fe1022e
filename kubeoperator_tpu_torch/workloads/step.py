"""The sharded-training tenant workload: a (data, fsdp, tp) AdamW step
behind one compile seam (port of `workloads/step.py`).

Models, picked by the configuration's type in one place for each of the
param tree, the initial state, the batch, the forward, the loss, the FLOP
count and the partition rules:

* `NetConfig`: the validation net's dense stage (rms-norm → causal
  multi-head attention → Megatron-shape FFN → readout, loss sum(y²)) over
  the net's own dims, with the reference's rounding points (`_forward`);
* `MlaMoeConfig`: the DeepSeek-V3 block of Kimi K2, latent attention and
  routed experts on one expert-parallel card's share, over token ids with
  a cross-entropy loss (`workloads/mla_moe.py`).

The dense stage's arithmetic is the reference's, below. The reference
writes it once in global-array form and lets its compiler lay it out; the
port runs it as explicit SPMD on each rank's blocks, in two modes with the
reference's names:

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

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from kubeoperator_tpu_torch.ops.attention import (
    MAX_DH,
    PAIRS,
    attention_reference,
    causal_attention,
)
from kubeoperator_tpu_torch.parallel.comm import all_gather, psum, replicate
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec, mesh_device, mesh_sizes
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig, rms
from kubeoperator_tpu_torch.utils.errors import ValidationError
from kubeoperator_tpu_torch.utils.spans import span
from kubeoperator_tpu_torch.weights import bf16_from_f64, local_shard, spec_axes
from kubeoperator_tpu_torch.workloads import mla_moe
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
BATCH_SPEC = (DATA_AXES, None, None)

# AdamW for this workload (NetConfig.lr is the validation net's SGD step)
ADAMW_LR = 1e-2
ADAMW_WEIGHT_DECAY = 1e-4
# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
_INT32_MAX = 2 ** 31 - 1


def default_rules(cfg=None):
    """The workload's layout as ordered (regex, spec) rules. First match
    wins; `w_head` is named so `explain_rules` reads as documentation. An
    `MlaMoeConfig` takes its own (`mla_moe.default_rules`)."""
    if isinstance(cfg, MlaMoeConfig):
        return mla_moe.default_rules()
    return (
        (r"wqkv$", ("fsdp", None)),        # ZeRO-3: rows sharded on fsdp
        (r"w_in$", (None, "tp")),          # megatron col-parallel
        (r"w_out$", ("tp", None)),         # megatron row-parallel
        (r"w_head$", (None, None)),        # replicated readout
    )


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


def torch_dtype(cfg: NetConfig | MlaMoeConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _cast(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float64 host draw in `dtype`, rounded as the reference rounds it."""
    if dtype == torch.bfloat16:
        return bf16_from_f64(a)
    return torch.from_numpy(a.astype(np.float32))


def param_shapes(cfg: NetConfig | MlaMoeConfig | None = None) -> dict:
    """Abstract param tree, in the reference's draw order."""
    cfg = cfg or NetConfig()
    if isinstance(cfg, MlaMoeConfig):
        return {name: ShapeDtypeStruct(shape, dt)
                for name, (shape, dt) in mla_moe.param_shapes(cfg).items()}
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg)
    shapes = {
        "wqkv": (d, 3 * d),
        "w_in": (d, f),
        "w_out": (f, d),
        "w_head": (d, d),
        # a non-trainable scalar rides the tree on purpose: the rule
        # engine's scalar exemption is part of the workload contract
        "step": (),
    }
    return {name: ShapeDtypeStruct(shape, torch.float32 if name == "step" else dt)
            for name, shape in shapes.items()}


def build_host_params(cfg: NetConfig | MlaMoeConfig | None = None,
                      seed: int = 0) -> dict:
    """Param tree as CPU tensors from numpy's `default_rng(seed)`, drawn and
    rounded as the reference draws them (an `MlaMoeConfig`: its own
    per-leaf draw, `mla_moe.init_params`, on the host)."""
    cfg = cfg or NetConfig()
    if isinstance(cfg, MlaMoeConfig):
        return mla_moe.init_params(cfg, seed, "cpu")
    rng = np.random.default_rng(seed)
    out = {}
    for name, sds in param_shapes(cfg).items():
        if name == "step":
            out[name] = torch.zeros((), dtype=torch.float32)
        else:
            out[name] = _cast(rng.standard_normal(sds.shape) * 0.05, sds.dtype)
    return out


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


def adamw_lr(cfg: NetConfig | MlaMoeConfig) -> float:
    """The configuration's AdamW learning rate: an `MlaMoeConfig`'s own
    `lr`; the dense stage's `ADAMW_LR` (`NetConfig.lr` is the validation
    net's SGD step)."""
    return cfg.lr if isinstance(cfg, MlaMoeConfig) else ADAMW_LR


def frozen_leaves(cfg: NetConfig | MlaMoeConfig) -> tuple[str, ...]:
    """The leaves of the param tree no gradient moves: the step counter
    (and an `MlaMoeConfig`'s routing biases)."""
    return mla_moe.frozen(cfg) if isinstance(cfg, MlaMoeConfig) else ("step",)


def train_state_shapes(cfg: NetConfig | None = None) -> dict:
    """Abstract TrainState tree ``{"params", "opt"}``: the Adam moments
    carry the params' names (matched by the same rules), and `opt/0/count`
    is a 0-d int32 leaf the scalar exemption claims."""
    params = param_shapes(cfg)
    return {"params": params,
            "opt": _opt_state(ShapeDtypeStruct((), torch.int32),
                              dict(params), dict(params))}


def build_host_state(cfg: NetConfig | None = None, seed: int = 0) -> dict:
    """Host TrainState: seeded params + the optimizer's zero state."""
    params = build_host_params(cfg, seed)
    return {"params": params, "opt": make_optimizer().init(params)}


def init_train_state(mesh: DeviceMesh, cfg: NetConfig | MlaMoeConfig | None = None,
                     seed: int = 0, specs=None) -> dict:
    """Host TrainState placed onto `mesh`: this rank's blocks per the spec
    tree (pjit), the whole of it otherwise (shard_map). An `MlaMoeConfig`'s
    parameters are drawn on the mesh's device itself."""
    if isinstance(cfg, MlaMoeConfig):
        params = mla_moe.init_params(cfg, seed, mesh_device(mesh))
        host = {"params": params, "opt": make_optimizer().init(params)}
    else:
        host = build_host_state(cfg, seed)
    if specs is None:
        specs = replicated_specs(host)
    shard_fn, _ = make_shard_and_gather_fns(mesh, specs)
    return shard_fn(host)


def build_batch(mesh: DeviceMesh, cfg: NetConfig | MlaMoeConfig | None = None,
                seed: int = 1) -> torch.Tensor:
    """This rank's block of the global [b_local·data·fsdp, seq, d_model]
    batch (an `MlaMoeConfig`: [b_local·data·fsdp, seq + 1] token ids),
    cut over the (data, fsdp) axes. Weak scaling on the batch axes: the
    per-rank batch stays `cfg.b_local` whatever the mesh shape."""
    cfg = cfg or NetConfig()
    sizes = mesh_sizes(mesh)
    if isinstance(cfg, MlaMoeConfig):
        host = mla_moe.token_batch(
            cfg, cfg.b_local * sizes["data"] * sizes["fsdp"], seed)
        return local_shard(host, BATCH_SPEC[:2], mesh).to(mesh_device(mesh))
    rng = np.random.default_rng(seed)
    host = _cast(rng.standard_normal(
        (cfg.b_local * sizes["data"] * sizes["fsdp"], cfg.s_local, cfg.d_model)),
        torch_dtype(cfg))
    return local_shard(host, BATCH_SPEC, mesh).to(mesh_device(mesh))


def _forward(p: dict, x: torch.Tensor, cfg: NetConfig | MlaMoeConfig,
             tp=None) -> torch.Tensor:
    """The dense stage on whole weights (w_in / w_out: this rank's tp blocks
    when `tp`, the group they are cut over, is given), with the reference's
    rounding points: rms squares in x's type; attention as
    `ops/attention.py::attention_reference` has them (the logits product
    in x's type, widened to f32 and only then divided by sqrt(dh), the
    causal mask -1e30, softmax in f32, cast back); tanh gelu. An
    `MlaMoeConfig`: the logits of token ids x (`mla_moe.forward`)."""
    if isinstance(cfg, MlaMoeConfig):
        return mla_moe.forward(p, x, cfg)
    d, h = cfg.d_model, cfg.heads
    dh = d // h
    bsz, seq = x.shape[0], x.shape[1]

    def heads4(t):
        return t.reshape(bsz, seq, h, dh)

    with span("block.attention"):
        qkv = rms(x) @ p["wqkv"]
        q, k, v = (heads4(t) for t in torch.split(qkv, d, dim=-1))
        # f32 keeps the plain chain on every device; bf16 goes to the fused
        # kernels on a card and to the same plain chain on the host
        attend = (attention_reference if x.dtype == torch.float32
                  else causal_attention)
        hx = x + attend(q, k, v)
    with span("block.ffn"):
        f_in = rms(hx)
        if tp is not None:
            f_in = replicate(f_in, tp)
        ff = F.gelu(f_in @ p["w_in"], approximate="tanh") @ p["w_out"]
        if tp is not None:
            ff = psum(ff, tp)
        hx = hx + ff
    return hx @ p["w_head"]


def _loss_size(cfg: NetConfig | MlaMoeConfig, sizes: dict) -> float:
    """What the step's loss is a mean over: every output entry of the dense
    stage's global batch, or every predicted token."""
    rows = cfg.b_local * sizes["data"] * sizes["fsdp"]
    if isinstance(cfg, MlaMoeConfig):
        return float(rows * cfg.s_local)
    return float(rows * cfg.s_local * cfg.d_model)


def _loss(p: dict, x: torch.Tensor, cfg: NetConfig | MlaMoeConfig,
          denom: float, tp=None) -> torch.Tensor:
    """This rank's share of the step's loss: sum(y²) / denom of the dense
    stage's output, or the sum of the cross-entropy of each next id over
    denom (`mla_moe.loss_sum`)."""
    if isinstance(cfg, MlaMoeConfig):
        return mla_moe.loss_sum(p, x, cfg) / denom
    y = _forward(p, x, cfg, tp).float()
    return torch.sum(y * y) / denom


def analytic_step_flops(mesh: DeviceMesh | MeshSpec,
                        cfg: NetConfig | MlaMoeConfig | None = None) -> float:
    """Model FLOPs for one global step from the architecture alone
    (matmuls at 2·m·n·k, full-matrix attention per the standard MFU
    convention, backward as 2× forward; an `MlaMoeConfig`:
    `mla_moe.step_flops`)."""
    cfg = cfg or NetConfig()
    sizes = mesh_sizes(mesh)
    b = cfg.b_local * sizes["data"] * sizes["fsdp"]
    if isinstance(cfg, MlaMoeConfig):
        return mla_moe.step_flops(cfg, b * cfg.s_local)
    s, d, f = cfg.s_local, cfg.d_model, cfg.d_ff
    fwd = (
        6 * b * s * d * d          # qkv projection [d -> 3d]
        + 4 * b * s * s * d        # attention: qk^T + av
        + 2 * b * s * d * f        # FFN in
        + 2 * b * s * f * d        # FFN out
        + 2 * b * s * d * d        # readout head
    )
    return 3.0 * fwd


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


def check_attention_width(mesh: DeviceMesh,
                          cfg: NetConfig | MlaMoeConfig) -> None:
    """ValidationError for a bf16 config on a card whose head width the
    fused attention is not built for (`ops/attention.py::MAX_DH`, or its
    `PAIRS` of q·k and v widths for an `MlaMoeConfig`), when the step or
    forward is built rather than at its first call."""
    if cfg.dtype != "bfloat16" or mesh.device_type != "cuda":
        return
    if isinstance(cfg, MlaMoeConfig):
        pair = (cfg.qk_head_dim, cfg.v_head_dim)
        if pair not in PAIRS:
            raise ValidationError(
                f"a bfloat16 run on a card takes latent attention's head "
                f"widths {PAIRS}, not {pair}")
        return
    dh = cfg.d_model // cfg.heads
    if dh > MAX_DH:
        raise ValidationError(
            f"a bfloat16 run on a card takes head widths up to {MAX_DH} "
            f"(d_model / heads), not {dh}")


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


def compile_step(mesh: DeviceMesh, cfg: NetConfig | MlaMoeConfig | None = None,
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
    optimizer = make_optimizer(adamw_lr(cfg) if lr is None else lr)
    sizes = check_workload_mesh(mesh, "workload")
    check_attention_width(mesh, cfg)
    if specs is not None and (not isinstance(specs, dict)
                              or set(specs) != {"params", "opt"}):
        raise PartitionError(
            "compile_step shards the full TrainState: specs must be the "
            "{'params', 'opt'} tree from "
            "match_partition_rules(rules, train_state_shapes()) — a "
            "params-only spec tree leaves the optimizer state unlaid-out")
    if mode == "auto":
        mode = "pjit" if specs is not None else "shard_map"
    denom = _loss_size(cfg, sizes)
    if mode == "pjit":
        if specs is None:
            raise PartitionError(
                "compile mode 'pjit' needs explicit shardings — run the "
                "partition rules first, or use mode 'shard_map'")
        pspecs = specs["params"]
        moment_specs = specs["opt"][0]
        megatron = megatron_pair(pspecs)
    elif mode != "shard_map":
        raise PartitionError(
            f"unknown compile mode {mode!r} (auto|pjit|shard_map)")
    else:
        pspecs, moment_specs, megatron = None, None, False
    groups = {a: mesh.get_group(a) for a in WORKLOAD_AXES}
    data_groups = [groups[a] for a in DATA_AXES if sizes[a] > 1]
    fixed = frozen_leaves(cfg)
    trainable = [k for k in param_shapes(cfg) if k not in fixed]

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
        loss = _loss(whole, x, cfg, denom, groups["tp"] if megatron else None)
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


def make_train_step(mesh: DeviceMesh, cfg: NetConfig | MlaMoeConfig | None = None,
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
    if used == "shard_map":
        specs = None
    return step, specs, used

