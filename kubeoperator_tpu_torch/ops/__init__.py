"""Node-validation workloads of the port (the NCCL-tests replacement family).

  collectives.py  collective bus-bandwidth (psum, all_gather,
                  reduce_scatter, ppermute, all_to_all) over a device mesh
  matmul.py       tensor-core sustained bf16 throughput
  hbm.py          device-memory stream bandwidth (one-pass triad)
  dma_read.py     explicit double-buffered copy read stream: kernel K1,
                  hand-written CUDA in csrc/dma_read.cu
  ring_gather.py  explicit neighbour ring all-gather: kernel K2,
                  hand-written CUDA in csrc/ring_all_gather.cu (one card
                  with n virtual ranks, or one process per card)
  attention.py    the dense stage's fused causal attention: kernel K3,
                  hand-written CUDA in csrc/attention.cu (forward and a
                  backward with no atomics)
  longcontext_check.py  ring-attention exactness + throughput over the
                  ring (the long-context path of parallel/longcontext.py)
  train_smoke.py  a few sharded training steps of the validation net
                  (parallel/validation_net.py), emitting KO_TPU_TRAIN_RESULT
  psum_smoke.py   the cluster smoke test: correctness, ring attention at
                  2+ ranks, psum bus-bandwidth, the train smoke when
                  KO_TPU_TRAIN_STEPS>0, emitting KO_TPU_SMOKE_RESULT
  dcn_smoke.py    the multislice smoke: one process per host through the
                  env contract, a psum across slices and one inside a slice

Only what is ported is exported; see ROADMAP.md for the rest. The kernel
wrappers themselves stay in their modules (`ops.dma_read.dma_read`,
`ops.ring_gather.ring_all_gather`, `ops.attention.causal_attention`), each
with its launch count
(`.launches`).
"""

from kubeoperator_tpu_torch.ops.collectives import (
    CollectiveResult,
    bench_collective,
    run_collective_suite,
    verify_psum_correctness,
)
from kubeoperator_tpu_torch.ops.dma_read import (
    DmaReadResult,
    dma_read_bandwidth_gbps,
)
from kubeoperator_tpu_torch.ops.hbm import HbmResult, hbm_bandwidth_gbps
from kubeoperator_tpu_torch.ops.longcontext_check import (
    RingAttentionResult,
    bench_ring_attention,
    verify_ring_attention,
)
from kubeoperator_tpu_torch.ops.matmul import MatmulResult, mxu_matmul_tflops
from kubeoperator_tpu_torch.ops.ring_gather import (
    bench_ring_all_gather,
    ring_all_gather,
    verify_ring_all_gather,
)
from kubeoperator_tpu_torch.ops.train_smoke import run_train_smoke

__all__ = [
    "CollectiveResult",
    "bench_collective",
    "run_collective_suite",
    "verify_psum_correctness",
    "DmaReadResult",
    "dma_read_bandwidth_gbps",
    "HbmResult",
    "hbm_bandwidth_gbps",
    "RingAttentionResult",
    "bench_ring_attention",
    "verify_ring_attention",
    "MatmulResult",
    "mxu_matmul_tflops",
    "bench_ring_all_gather",
    "ring_all_gather",
    "verify_ring_all_gather",
    "run_train_smoke",
]
