"""The validation net: a small transformer trained with every parallelism
family the framework owns (port of `parallel/validation_net.py`).

Parallelism map over a (dp, pp, sp, tp) mesh of process ranks:
  dp — batch data-parallel
  pp — circular pipeline: every pp rank starts from the same batch and, for
       pp hops, applies its own stage and passes the activation to pp
       rank + 1 (`ppermute`)
  sp — sequence parallel: exact causal ring attention
       (`parallel/longcontext.py`), plus MoE token routing to one expert
       per sp rank through `all_to_all` over the same ranks
  tp — Megatron FFN: column-parallel in, row-parallel out, summed over tp
Each rank holds its local shard of every parameter (`param_specs`: which
dim is cut along which axis) and of the batch. Stages run under
`torch.utils.checkpoint` as `NetConfig.remat` says.

Gradients. Every rank runs backward on the same replicated loss; the
collectives' backwards (`parallel/comm.py`) carry cotangents between ranks,
so each rank gets the gradient of the global loss with respect to its own
copy of each parameter. A parameter replicated along an axis whose ranks
see different data (dp, sp, pp) has one copy per coordinate there, and the
step sums their gradients along those axes (`grad_sum_axes`). tp ranks see
the same data, so they need no sum. The result is the plain full-batch
gradient of the global loss, which is what the reference's step computes.

Host state is built in numpy from `seed` in the reference's draw order
(parameters, then the batch), so both packages start from the same bits.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kubeoperator_tpu_torch.parallel.comm import (
    all_to_all,
    axes_group,
    ppermute,
    psum,
    replicate,
)
from kubeoperator_tpu_torch.parallel.longcontext import ring_attention_local
from kubeoperator_tpu_torch.parallel.mesh import (
    MeshSpec,
    mesh_device,
    mesh_sizes,
)
from kubeoperator_tpu_torch.weights import from_f64, local_shard, place

# model dims: every sharded dim divides any power-of-two axis size up to 8
# (see axis_sizes)
D_MODEL, D_FF, HEADS = 64, 128, 8
B_LOCAL, S_LOCAL = 2, 16
AXES = ("dp", "pp", "sp", "tp")
DATA_AXES = ("dp", "sp", "pp")   # axes whose ranks see different data
BATCH_SPEC = ("dp", "sp", None)  # x: [b_local·dp, s_local·sp, d_model]


@dataclass(frozen=True)
class NetConfig:
    """Validation-net dimensions. The default is the tiny CI/smoke shape;
    the bench passes a card-filling shape (plus bf16) so the measured MFU
    reflects the tensor cores, not dispatch latency."""

    d_model: int = D_MODEL
    d_ff: int = D_FF
    heads: int = HEADS
    b_local: int = B_LOCAL
    s_local: int = S_LOCAL
    dtype: str = "float32"     # "bfloat16" for tensor-core-rate benching
    lr: float = 0.1            # SGD step; scale-appropriate per config
    # rematerialisation policy for the stage block under grad:
    #   full — checkpoint the stage, recompute everything in backward
    #   dots — save the products with a 2-D weight, recompute the rest
    #   none — no checkpoint; autograd keeps what backward needs
    remat: str = "full"


# the reference's card-filling bench shape (d_h = 512 heads, an 8x FFN),
# bf16, no remat; `bench.py` runs it for 12 steps
BENCH_CONFIG = NetConfig(
    d_model=4096, d_ff=32768, heads=8, b_local=48, s_local=1024,
    dtype="bfloat16", lr=5e-4, remat="none",
)


def axis_sizes(n_devices: int) -> tuple[int, int, int, int]:
    """Factor n into (dp, pp, sp, tp). tp shards d_ff and sp shards
    seq/experts, so those two axes only take powers of two (capped at 8 —
    the model dims divide any such size); pp stacks a per-stage leading dim
    and dp shards batch, so they absorb everything else, odd factors
    included. 8 -> (1,2,2,2), 16 -> (2,2,2,2), 12 -> (3,1,2,2)."""
    twos = 0
    m = n_devices
    while m % 2 == 0:
        twos += 1
        m //= 2
    sizes = {"tp": 1, "sp": 1, "pp": 1, "dp": 1}
    order = ["tp", "sp", "pp", "dp"]
    i = 0
    for _ in range(twos):
        while order[i % 4] in ("tp", "sp") and sizes[order[i % 4]] >= 8:
            i += 1
        sizes[order[i % 4]] *= 2
        i += 1
    sizes["dp"] *= m  # odd remainder: batch shards any size
    return sizes["dp"], sizes["pp"], sizes["sp"], sizes["tp"]


def analytic_train_flops(mesh: DeviceMesh | MeshSpec,
                         cfg: NetConfig | None = None) -> float:
    """Model FLOPs for ONE global train step, from the architecture alone.

    Counts every matmul's 2·m·n·k on its LOCAL shard shapes, times pipeline
    hops, times devices; backward counted as 2x forward (the standard MFU
    convention — remat recompute deliberately excluded, so reported MFU is
    conservative)."""
    cfg = cfg or NetConfig()
    sizes = mesh_sizes(mesh)
    dp, pp, sp, tp = (sizes[a] for a in AXES)
    n_devices = dp * pp * sp * tp
    b, s, d, f = cfg.b_local, cfg.s_local, cfg.d_model, cfg.d_ff
    n_exp = sp
    tokens = b * s
    per_hop = (
        6 * b * s * d * d                 # qkv projection [d -> 3d]
        + 4 * b * s * s * d * sp          # ring attention: qk^T + av, sp hops
        + 2 * b * s * d * (f // tp)       # FFN in (col-parallel local shard)
        + 2 * b * s * (f // tp) * d       # FFN out (row-parallel local shard)
        + 2 * tokens * d * n_exp          # MoE gate
        + 2 * tokens * d * d              # MoE expert FFN (post all_to_all)
    )
    per_device = per_hop * pp + 2 * b * s * d * d   # + readout head
    return 3.0 * per_device * n_devices             # fwd + 2x bwd


def mesh_spec_for(n_devices: int) -> MeshSpec:
    """The validation net's factored (dp, pp, sp, tp) axes as a MeshSpec."""
    return MeshSpec(axes=tuple(zip(AXES, axis_sizes(n_devices))))


def build_mesh_for(device_type: str | None = None) -> DeviceMesh:
    """(dp, pp, sp, tp) mesh over every rank of the default group."""
    return mesh_spec_for(dist.get_world_size()).build(device_type)


def param_specs() -> dict[str, tuple[str | None, ...]]:
    """Placement table: the mesh axis each parameter dim is cut along
    (None: whole). The leading dim of a stage weight is the stage, on pp."""
    return {
        "wqkv": ("pp", None, None),          # [pp, d, 3d] per-stage
        "w_in": ("pp", None, "tp"),          # [pp, d, d_ff] col-parallel
        "w_out": ("pp", "tp", None),         # [pp, d_ff, d] row-parallel
        "w_gate": ("pp", None, None),        # [pp, d, n_exp]
        "w_exp": ("pp", "sp", None, None),   # [pp, n_exp, d, d] ep-sharded
        "w_head": (None, None),              # [d, d] replicated readout
    }


def grad_sum_axes(spec: tuple[str | None, ...]) -> tuple[str, ...]:
    """The data-carrying axes a parameter with placement `spec` is
    replicated along: its gradient is summed over them."""
    return tuple(a for a in DATA_AXES if a not in spec)


def host_params_and_batch(sizes: dict[str, int], seed: int = 0,
                          cfg: NetConfig | None = None
                          ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The global parameters and batch as CPU tensors, drawn from numpy's
    `default_rng(seed)` in the reference's order and scale."""
    cfg = cfg or NetConfig()
    pp, sp = sizes["pp"], sizes["sp"]
    n_exp = sp
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return from_f64(rng.standard_normal(shape) * scale, cfg.dtype)

    host = {
        "wqkv": w(pp, cfg.d_model, 3 * cfg.d_model),
        "w_in": w(pp, cfg.d_model, cfg.d_ff),
        "w_out": w(pp, cfg.d_ff, cfg.d_model),
        "w_gate": w(pp, cfg.d_model, n_exp),
        "w_exp": w(pp, n_exp, cfg.d_model, cfg.d_model),
        "w_head": w(cfg.d_model, cfg.d_model),
    }
    x = from_f64(rng.standard_normal(
        (cfg.b_local * sizes["dp"], cfg.s_local * sp, cfg.d_model)), cfg.dtype)
    return host, x


def build_params_and_batch(mesh: DeviceMesh, seed: int = 0,
                           cfg: NetConfig | None = None):
    """numpy-built params + input batch, this rank's shards on the mesh's
    device. Returns (params, x, host) with `host` the global parameters as
    CPU tensors."""
    host, x = host_params_and_batch(mesh_sizes(mesh), seed, cfg)
    dev = mesh_device(mesh)
    params = place(host, mesh, param_specs(), dev)
    return params, local_shard(x, BATCH_SPEC, mesh).to(dev), host


def rms(h: torch.Tensor) -> torch.Tensor:
    """RMS norm as the reference computes it: the square in h's type, the
    mean and rsqrt in f32, the factor cast back to h's type before the
    product (in bf16 this differs from squaring in f32)."""
    return h * torch.rsqrt(
        (h * h).float().mean(dim=-1, keepdim=True) + 1e-6).to(h.dtype)


def _save_dots_policy(ctx, op, *args, **kwargs):
    # products with a 2-D weight lower to mm/addmm; batched products
    # (attention) to bmm, which is recomputed: the analogue of
    # dots_with_no_batch_dims_saveable
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn):
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots_policy))
    if policy == "none":
        return fn
    # a typo'd policy silently running without checkpointing would run out
    # of memory on large runs or misattribute benchmark numbers
    raise ValueError(f"unknown remat policy {policy!r} (full|dots|none)")


def make_train_step(mesh: DeviceMesh, lr: float | None = None,
                    cfg: NetConfig | None = None):
    """(params, x) -> (loss, new_params) over the mesh: one SGD step on
    this rank's shards. Every rank of the mesh calls it together."""
    cfg = cfg or NetConfig()
    lr = cfg.lr if lr is None else lr
    d_model, heads = cfg.d_model, cfg.heads
    b_local, s_local = cfg.b_local, cfg.s_local
    sizes = mesh_sizes(mesh)
    dp, pp, sp, tp = (sizes[a] for a in AXES)
    groups = {a: mesh.get_group(a) for a in AXES}
    loss_group = axes_group(mesh, DATA_AXES)
    n_exp = sp
    tokens_local = b_local * s_local
    cap = tokens_local // n_exp     # static capacity routing
    batch, seq = b_local * dp, s_local * sp

    def stage_block(h, wqkv, w_in, w_out, w_gate, w_exp):
        """One pipeline stage: ring attention (sp) + Megatron FFN (tp) +
        MoE token routing (ep == sp ranks). Weights are this rank's local
        shards (leading stage dim already indexed away)."""
        qkv = rms(h) @ wqkv                                # [b, s, 3d]
        q, k, v = torch.split(qkv, d_model, dim=-1)
        shape4 = (b_local, s_local, heads, d_model // heads)
        a = ring_attention_local(
            q.reshape(shape4), k.reshape(shape4), v.reshape(shape4),
            groups["sp"], n=sp, causal=True,
        ).reshape(b_local, s_local, d_model).to(h.dtype)
        h = h + a
        f = F.gelu(replicate(rms(h), groups["tp"]) @ w_in,
                   approximate="tanh")                     # [b, s, d_ff/tp]
        h = h + psum(f @ w_out, groups["tp"])              # row-parallel
        t = rms(h).reshape(tokens_local, d_model)
        g = torch.softmax(t @ w_gate, dim=-1)              # [T, n_exp]
        gsel = torch.diagonal(                             # token i -> expert
            g.reshape(cap, n_exp, n_exp), dim1=1, dim2=2)  # i % n_exp
        xs = t.reshape(cap, n_exp, d_model).transpose(0, 1)
        xr = all_to_all(xs, groups["sp"])                  # tokens to experts
        ye = F.gelu(xr @ w_exp[0], approximate="tanh")     # my expert's FFN
        yt = all_to_all(ye, groups["sp"])                  # results back
        routed = yt.transpose(0, 1).reshape(tokens_local, d_model)
        moe = gsel.reshape(tokens_local, 1) * routed
        return h + moe.reshape(b_local, s_local, d_model)

    block = _remat(cfg.remat, stage_block)

    def loss_local(p, xb):
        """Circular pipeline: this pp rank's stream hops through every
        stage (pp hops), each rank always applying its own stage weights
        to whatever activation arrives. The loss sums over (dp, sp, pp) in
        f32; tp ranks hold the same value."""
        h = xb
        for _ in range(pp):
            h = block(h, p["wqkv"][0], p["w_in"][0], p["w_out"][0],
                      p["w_gate"][0], p["w_exp"][0])
            h = ppermute(h, groups["pp"])
        y32 = (h @ p["w_head"]).float()
        part = torch.sum(y32 * y32) / (batch * seq * d_model * pp)
        return psum(part, loss_group)

    sum_over = {k: [groups[a] for a in grad_sum_axes(spec) if sizes[a] > 1]
                for k, spec in param_specs().items()}

    def train_step(params: dict[str, torch.Tensor], x: torch.Tensor):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_local(p, x)
        grads = torch.autograd.grad(loss, list(p.values()))
        new_params = {}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                for group in sum_over[k]:
                    dist.all_reduce(g, group=group)
                new_params[k] = v - lr * g
        return loss.detach(), new_params

    return train_step
