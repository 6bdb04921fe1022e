"""Sharded-training tenant workloads (port of `kubeoperator_tpu/workloads/`).

* `partition` — the partition-rule engine: ordered (regex, spec) rules
  over /-joined tree paths, shard/gather fns, the `explain_rules` report;
* `step` — the (data, fsdp, tp) AdamW step behind ONE `compile_step`
  seam: pjit when explicit specs exist, shard_map fallback; its `MODELS`
  maps a configuration to its model, `dense` or `mla_moe` (Kimi K2);
* `harness` — `run_training` and the per-axis scaling / MFU sweep behind
  the `KO_TPU_WORKLOAD_RESULT` line;
* `checkpoint` — content-hashed per-leaf checkpoints, the reference's
  files byte for byte;
* `serve` — the resident forward behind `run_serving`.

The queue's decision layer (`workloads/queue.py` in the reference) touches
no device and is not ported.
"""

from kubeoperator_tpu_torch.workloads.partition import (
    PartitionError,
    explain_rules,
    make_shard_and_gather_fns,
    match_partition_rules,
    tree_paths,
)
from kubeoperator_tpu_torch.workloads.step import (
    WORKLOAD_AXES,
    compile_step,
    default_rules,
    make_train_step,
)

__all__ = [
    "PartitionError",
    "WORKLOAD_AXES",
    "compile_step",
    "default_rules",
    "explain_rules",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "make_train_step",
    "tree_paths",
]
