"""Node-validation workloads of the port (the NCCL-tests replacement family).

  collectives.py  collective bus-bandwidth (psum, all_gather,
                  reduce_scatter, ppermute, all_to_all) over a device mesh
  matmul.py       tensor-core sustained bf16 throughput
  hbm.py          device-memory stream bandwidth (one-pass triad)
  dma_read.py     explicit double-buffered copy read stream: kernel K1,
                  hand-written CUDA in csrc/dma_read.cu
  psum_smoke.py   the cluster smoke test: correctness + psum bus-bandwidth,
                  emitting KO_TPU_SMOKE_RESULT

Only what is ported is exported; see ROADMAP.md for the rest. The kernel
wrapper itself stays in its module (`ops.dma_read.dma_read`, with its
launch count `ops.dma_read.dma_read.launches`).
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
from kubeoperator_tpu_torch.ops.matmul import MatmulResult, mxu_matmul_tflops

__all__ = [
    "CollectiveResult",
    "bench_collective",
    "run_collective_suite",
    "verify_psum_correctness",
    "DmaReadResult",
    "dma_read_bandwidth_gbps",
    "HbmResult",
    "hbm_bandwidth_gbps",
    "MatmulResult",
    "mxu_matmul_tflops",
]
