"""The graft entry, ported (twin of the root `__graft_entry__.py`).

`entry(device=None)` returns ``(fn, args)``: one causal transformer block
(rms-norm, full attention, out-projection, rms-norm, tanh-gelu FFN) in
bf16, the reference's single-chip forward, with its inputs built in numpy
from ``default_rng(0)`` and rounded to bf16 as the reference rounds them.
The args lie on the card unless the caller names another device
(`utils/device.py::resolve_device`); `fn` runs where its args are.

`dryrun_multichip(n, device="cpu")` runs one full training step (forward,
backward, SGD) of the validation net over an n-rank (dp, pp, sp, tp) mesh
(`parallel/validation_net.py::axis_sizes`) and checks it as the reference
does: a finite loss, a finite `w_in`, and `w_in` changed. The reference
finds n virtual CPU devices in one process and prefers them on purpose;
torch puts one rank in each process, so the port starts n processes
through the host env contract, gloo ranks on the host by default.
``device="cuda"`` runs one rank per card and refuses with fewer cards.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeoperator_tpu_torch.parallel import validation_net as vnet
from kubeoperator_tpu_torch.parallel.longcontext import _NEG, _bmm_f32
from kubeoperator_tpu_torch.parallel.mesh import mesh_sizes
from kubeoperator_tpu_torch.parallel.multislice import HostEnv, initialize_from_env
from kubeoperator_tpu_torch.utils.device import resolve_device
from kubeoperator_tpu_torch.utils.launch import free_port_pair, run_ranks
from kubeoperator_tpu_torch.weights import bf16_from_f64

BATCH, SEQ, D_MODEL, HEADS = 4, 512, 1024, 8
RESULT_MARKER = "KO_TPU_DRYRUN_RESULT"


def _rms(hf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """rms-norm of the float32 `hf`, cast to `dtype` once at the end."""
    return (hf * torch.rsqrt((hf * hf).mean(dim=-1, keepdim=True) + 1e-6)
            ).to(dtype)


def _dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] @ [K, N] with a float32 result: on the card a bf16 product
    accumulates into f32 (`aten::bmm.dtype`), as the reference's
    `preferred_element_type=f32`; on the host the operands are widened,
    which is exact for bf16."""
    out = _bmm_f32(a.reshape(-1, a.shape[-1]), w)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over [batch, seq, heads, dim] in q's type, rounded
    where the reference's `reference_attention` is rounded as XLA runs it:
    each product in f32 rounded once, the scale a value of q's type (a
    weakly typed Python float), the scaled and masked logits and their
    difference from the row max rounded, the exponentials summed in f32
    before they are rounded, and the quotient rounded."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = _bmm_f32(qh, kh.transpose(-1, -2)).to(dt)
    s = s * torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=dt)
    n = q.shape[1]
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, torch.tensor(_NEG, dtype=dt, device=q.device))
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)).float())
    p = e.to(dt) / e.sum(dim=-1, keepdim=True).to(dt)
    return _bmm_f32(p, vh).to(dt).transpose(1, 2)


def _forward(x, wqkv, wo, w1, w2):
    """The reference's `_forward` with its rounding points as XLA runs it:
    each product with an f32 result rounded to the args' type once
    afterwards, rms in f32 cast back, tanh gelu (the default of
    `jax.nn.gelu`). XLA fuses the first residual's cast away, so the
    second rms reads that sum in f32 and only the last add rounds it; the
    port does the same. In float32 every rounding is the identity."""
    dt = x.dtype
    b, s, d = x.shape
    qkv = _dot_f32(_rms(x.float(), dt), wqkv)
    q, k, v = torch.split(qkv.to(dt), d, dim=-1)
    shape4 = (b, s, HEADS, d // HEADS)
    a = _attention(q.reshape(shape4), k.reshape(shape4),
                   v.reshape(shape4)).reshape(b, s, d)
    x1 = x.float() + _dot_f32(a, wo).to(dt).float()
    h = _dot_f32(_rms(x1, dt), w1)
    h = F.gelu(h, approximate="tanh").to(dt)
    return x1.to(dt) + _dot_f32(h, w2).to(dt)


def block_inputs(batch: int = BATCH, seq: int = SEQ, d_model: int = D_MODEL,
                 seed: int = 0) -> tuple[torch.Tensor, ...]:
    """(x, wqkv, wo, w1, w2) as bf16 tensors on the host, drawn in the
    reference's order: x at scale 1, the weights at 0.02."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return bf16_from_f64(rng.standard_normal(shape) * scale)

    x = w(batch, seq, d_model, scale=1.0)
    return (x, w(d_model, 3 * d_model), w(d_model, d_model),
            w(d_model, 4 * d_model), w(4 * d_model, d_model))


def entry(device: torch.device | str | None = None):
    """(fn, example_args) for a single-card forward at the reference's
    block shape; the args lie on `device` (the card unless the caller
    names another), `fn` runs where they are."""
    dev = resolve_device(device)
    return _forward, tuple(t.to(dev) for t in block_inputs())


def _dryrun_rank(device: str) -> None:
    """One rank of `dryrun_multichip`: join the group from the env
    contract, one training step, the reference's three checks; rank 0
    prints the marker line."""
    dev = initialize_from_env(device)
    mesh = vnet.build_mesh_for(device_type=dev.type)
    params, x, _ = vnet.build_params_and_batch(mesh)
    w_in = params["w_in"].clone()
    loss, new_params = vnet.make_train_step(mesh)(params, x)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError("dryrun training step produced non-finite loss")
    w_new = new_params["w_in"]
    if not bool(torch.isfinite(w_new).all()):
        raise RuntimeError("dryrun SGD update produced non-finite weights")
    if torch.equal(w_new, w_in):
        raise RuntimeError("dryrun SGD update did not change the weights")
    if dist.get_rank() == 0:
        print(RESULT_MARKER + " " + json.dumps({
            "devices": dist.get_world_size(), "device_type": dev.type,
            "mesh": mesh_sizes(mesh), "loss": loss}), flush=True)
    dist.barrier()
    # no teardown: gloo can abort a rank whose peer, or the host of the
    # rendezvous store (rank 0), has already gone
    os._exit(0)


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     timeout_s: float = 600.0) -> dict:
    """One sharded training step over n ranks (module docstring). Raises
    RuntimeError if a rank fails a check or exits otherwise; returns rank
    0's report: devices, mesh and the loss."""
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} cards (one rank per card), "
            f"{torch.cuda.device_count()} visible")
    port = free_port_pair()
    envs = [HostEnv(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=n_devices, process_id=rank).to_env()
            for rank in range(n_devices)]
    ran = run_ranks("from kubeoperator_tpu_torch.graft_entry import "
                    f"_dryrun_rank; _dryrun_rank({device!r})", envs, timeout_s)
    for rank, (rc, _, err) in enumerate(ran):
        if rc != 0:
            raise RuntimeError(f"dryrun rank {rank} exit {rc}: {err[-2000:]}")
    lines = [ln for ln in ran[0][1].splitlines()
             if ln.startswith(RESULT_MARKER + " ")]
    return json.loads(lines[0].split(" ", 1)[1])
