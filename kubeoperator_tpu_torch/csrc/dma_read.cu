// K1: explicit read stream over device memory, one launch (sm_90a).
//
// Replaces kubeoperator_tpu/ops/pallas_kernels.py::_dma_read_kernel (the
// `pl.pallas_call` in `_dma_read`). Function:
//
//     out[8, 1024] = seed + x.view(-1, 8, 1024).sum(0)
//
// for a contiguous f32 x[rows, 1024] with rows a multiple of 256: row r of x
// lands in output row r % 8. The TPU kernel streams 256-row chunks HBM->VMEM
// with two async-copy slots, starting chunk i+1's copy before waiting on
// chunk i. A 1 MB chunk does not fit in 227 KB of shared memory, and one
// sequential stream cannot fill the card, so the schedule is rethought:
//
// The stream. A persistent grid (`nblocks`, one block per SM) deals the
// 8-row tiles (8 x 1024 x 4 B = 32 KB, contiguous) round-robin: block b
// takes tiles b, b + nblocks, ... (dma_read.tile_plan), so at any moment
// the grid reads one window of neighbouring tiles (one contiguous run per
// block measured no faster on an H100; PERF.md). In each block one
// elected thread of a producer warp copies tiles with Hopper's 1-D bulk
// copy (`cp.async.bulk ... mbarrier::complete_tx::bytes`, no tensor map)
// into a ring of kStages shared-memory stages, each with a "full"
// mbarrier that counts the bytes in and an "empty" one that the 8 consumer
// warps arrive on when they have summed the stage. Tiles are 8-row
// aligned, so tile row j is x row r with r % 8 == j: consumer thread t
// keeps float4 column t of every tile row (8 float4) in registers. The
// ring keeps kStages x 32 KB in flight per SM without a register or an
// instruction per byte; deeper rings measured no faster (PERF.md).
//
// The finish, in the same launch. Each block writes its [8, 1024] partial
// to scratch, fences, and takes a ticket from an atomic counter. The blocks
// with the last `finishers` tickets wait until every ticket is taken, then
// each sums one column slice of all partials in a fixed order (runs of
// blocks in block order, then the runs in order) and adds `seed`: the
// result is the same from run to run, and the partials' reads (nblocks x
// 32 KB, from L2) are spread over `finishers` SMs instead of one. The last
// finisher to end resets both counters for the next launch. The grid is
// launched cooperatively, so the waiting finishers cannot hold back a
// block that has yet to start. A finisher that waits past `timeout_ns`
// writes NaN to its slice instead of hanging the card. The host picks
// `finishers` (dma_read.finisher_count).
//
// What bounds it: bytes. It reads rows * 4096 bytes once and does one add
// per element, far below the card's rate of operations for float32 adds;
// the partials add nblocks x 32 KB written and read back, which stays in L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 1024;
constexpr int kTileRows = 8;
constexpr int kConsumers = 256;                      // 8 warps sum
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;            // + 1 producer warp
constexpr int kTileVec = kTileRows * kCols / 4;      // float4s in a tile: 2048
constexpr int kTileBytes = kTileVec * 16;            // 32 KiB
constexpr int kOutFloats = kTileRows * kCols;        // 8192
constexpr int kStages = 2;                           // 32 KiB stages a block
constexpr int kFinishUnroll = 8;  // partial loads a finisher thread has in flight

static_assert(kTileVec / kConsumers == kTileRows,
              "consumer t owns float4 column t of each tile row");

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// seed + s, or NaN where the finisher's wait timed out
__device__ __forceinline__ float4 finish4(const float4 s, float seed, int ok) {
  if (!ok) return make_float4(nanf(""), nanf(""), nanf(""), nanf(""));
  return make_float4(seed + s.x, seed + s.y, seed + s.z, seed + s.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Returns once the barrier's phase of parity `parity` has completed. A copy
// that never lands is a fault of the kernel: past `timeout_ns` it traps (the
// launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity,
                                          long long timeout_ns) {
  uint32_t done = 0;
  const unsigned long long t0 = global_timer_ns();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (static_cast<long long>(global_timer_ns() - t0) > timeout_ns) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire_gpu(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
dma_read_kernel(const float4* __restrict__ x, long long tiles,
                float4* __restrict__ partials, int finishers,
                const float* __restrict__ seed, float* __restrict__ out,
                unsigned int* counters, long long timeout_ns) {
  extern __shared__ __align__(128) float4 ring[];  // [kStages][kTileVec]
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int s_ticket;
  __shared__ int s_ok;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nblocks = gridDim.x;
  // dma_read.tile_plan: every nblocks-th tile from blockIdx.x
  const long long first = blockIdx.x;
  const long long step = nblocks;
  const long long count = (tiles - blockIdx.x + nblocks - 1) / nblocks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one elected thread keeps the ring full
    if (tid == kConsumers) {
      for (long long i = 0; i < count; ++i) {
        const int s = static_cast<int>(i % kStages);
        const long long round = i / kStages;
        if (round > 0) {
          mbar_wait(&empty[s], static_cast<uint32_t>((round - 1) & 1),
                    timeout_ns);
        }
        mbar_arrive_expect_tx(&full[s], kTileBytes);
        bulk_load(ring + s * kTileVec, x + (first + i * step) * kTileVec, kTileBytes,
                  &full[s]);
      }
    }
  } else {
    float4 acc[kTileRows];
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i = 0; i < count; ++i) {
      const int s = static_cast<int>(i % kStages);
      mbar_wait(&full[s], static_cast<uint32_t>((i / kStages) & 1), timeout_ns);
      const float4* stage = ring + s * kTileVec;
#pragma unroll
      for (int k = 0; k < kTileRows; ++k) add4(acc[k], stage[tid + k * kConsumers]);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[s]);
    }
    float4* p = partials + static_cast<long long>(blockIdx.x) * kTileVec;
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) p[tid + k * kConsumers] = acc[k];
  }

  // every partial of this block is written; publish it and take a ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_ticket = static_cast<int>(atomicAdd(&counters[0], 1u));
  }
  __syncthreads();
  const int f = s_ticket - (nblocks - finishers);
  if (f < 0) return;

  // finisher f: wait for every ticket, then sum its slice in block order
  if (tid == 0) {
    int ok = 1;
    const unsigned long long t0 = global_timer_ns();
    while (ld_acquire_gpu(&counters[0]) < static_cast<unsigned int>(nblocks)) {
      if (static_cast<long long>(global_timer_ns() - t0) > timeout_ns) {
        ok = 0;
        break;
      }
      __nanosleep(64);
    }
    s_ok = ok;
  }
  __syncthreads();
  // The slice is cols4 float4 columns. `groups` groups of `span` consumer
  // threads each sum a contiguous run of the partials in block order, with
  // kFinishUnroll loads in flight; the group sums are then added in group
  // order. The order is fixed, so the result is the same from run to run.
  const int cols4 = kTileVec / finishers;
  const int span = cols4 < kConsumers ? cols4 : kConsumers;
  const int groups = kConsumers / span;
  float4* group_sums = ring;  // [groups][span]: the stages are free now
  float4* out4 = reinterpret_cast<float4*>(out) + f * cols4;
  const float s0 = *seed;
  if (tid < kConsumers) {
    const int g = tid / span;
    const int b0 = nblocks * g / groups;
    const int b1 = nblocks * (g + 1) / groups;
    for (int col = tid % span; col < cols4; col += span) {
      const float4* p = partials + f * cols4 + col;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      int b = b0;
      for (; b + kFinishUnroll <= b1; b += kFinishUnroll) {
        float4 v[kFinishUnroll];
#pragma unroll
        for (int u = 0; u < kFinishUnroll; ++u) {
          v[u] = __ldcg(p + static_cast<long long>(b + u) * kTileVec);
        }
#pragma unroll
        for (int u = 0; u < kFinishUnroll; ++u) add4(s, v[u]);
      }
      for (; b < b1; ++b) add4(s, __ldcg(p + static_cast<long long>(b) * kTileVec));
      if (groups == 1) {
        out4[col] = finish4(s, s0, s_ok);
      } else {
        group_sums[g * span + col] = s;
      }
    }
  }
  __syncthreads();
  if (groups > 1 && tid < span) {
    float4 s = group_sums[tid];
    for (int g = 1; g < groups; ++g) add4(s, group_sums[g * span + tid]);
    out4[tid] = finish4(s, s0, s_ok);
  }
  __syncthreads();
  if (tid == 0) {
    if (atomicAdd(&counters[1], 1u) == static_cast<unsigned int>(finishers - 1)) {
      // every ticket is taken and every finisher is past its wait
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

}  // namespace

// x: f32 [rows, 1024], contiguous, 16-byte aligned, rows % 8 == 0.
// seed: f32 [1]. partials: f32 [nblocks, 8, 1024] scratch. counters: u32 [2],
// zero on the first launch (the kernel leaves them zero). Launches that
// share partials and counters must not overlap (the host keeps one set per
// stream). out: f32 [8, 1024]. 1 <= nblocks <= rows / 8, co-resident;
// finishers a power of two <= min(nblocks, 8192). Launches cooperatively
// on `stream`; does not synchronise. Returns the CUDA error code (0 on
// success).
extern "C" int ko_dma_read(const float* x, long long rows, const float* seed,
                           float* partials, int nblocks, int finishers,
                           unsigned int* counters, float* out,
                           long long timeout_ns, void* stream) {
  if (nblocks < 1 || finishers < 1 || finishers > nblocks ||
      kOutFloats % finishers != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kStages * kTileBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dma_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* xv = reinterpret_cast<const float4*>(x);
  long long tiles = rows / kTileRows;
  float4* pv = reinterpret_cast<float4*>(partials);
  void* args[] = {&xv, &tiles, &pv, &finishers, &seed, &out, &counters,
                  &timeout_ns};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(dma_read_kernel),
                                    dim3(nblocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
