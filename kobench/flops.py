"""Frozen model FLOP counts of the port's two model paths.

Copies of `kubeoperator_tpu_torch/workloads/step.py::analytic_step_flops`
and `parallel/validation_net.py::analytic_train_flops` as they stand when
the benchmark was defined, taking the configuration's dims as plain
numbers. A later change to the port's counting does not move the
benchmark's MFU. Convention: matmuls at 2·m·n·k, full-matrix attention,
backward counted as twice the forward, recomputation not counted.
"""

from __future__ import annotations


def dense_forward_flops(cfg: dict, mesh: dict) -> float:
    """One forward of the dense stage over the global batch."""
    b = cfg["b_local"] * mesh["data"] * mesh["fsdp"]
    s, d, f = cfg["s_local"], cfg["d_model"], cfg["d_ff"]
    return float(
        6 * b * s * d * d          # qkv projection [d -> 3d]
        + 4 * b * s * s * d        # attention: qk^T + av
        + 2 * b * s * d * f        # FFN in
        + 2 * b * s * f * d        # FFN out
        + 2 * b * s * d * d        # readout head
    )


def dense_step_flops(cfg: dict, mesh: dict) -> float:
    """One global training step of the dense stage (forward + 2x backward)."""
    return 3.0 * dense_forward_flops(cfg, mesh)


def vnet_step_flops(cfg: dict, mesh: dict) -> float:
    """One global training step of the validation net over a (dp, pp, sp,
    tp) mesh: each device's local products times pipeline hops, plus the
    readout, times devices, times 3."""
    dp, pp, sp, tp = (mesh[a] for a in ("dp", "pp", "sp", "tp"))
    b, s, d, f = cfg["b_local"], cfg["s_local"], cfg["d_model"], cfg["d_ff"]
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
    return 3.0 * per_device * dp * pp * sp * tp
