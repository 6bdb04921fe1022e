// K1: explicit double-buffered read stream over device memory (sm_90a).
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
// Pass 1 (dma_read_partial). Each of `nblocks` blocks owns a contiguous run
//   of 8-row tiles (8 x 1024 x 4 B = 32 KB). It streams them through two
//   shared-memory stages with 16-byte `cp.async` copies: tile i+1's copy is
//   in flight while tile i is summed, the counterpart of the TPU kernel's
//   `make_async_copy` double buffering. Because tiles are 8-row aligned,
//   tile row j is x row r with r % 8 == j. Thread t copies and sums float4
//   column t of every tile row, so it keeps its slice of the [8, 1024]
//   partial (8 float4) in registers and reads only shared words it copied
//   itself: `cp.async.wait_group` makes those visible to it, and no block
//   barrier is needed. Each block writes its partial to scratch
//   [nblocks, 8, 1024] that the wrapper allocates.
// Pass 2 (dma_read_finish). Sums the partials over blocks in a fixed order
//   (warp w takes blocks w, w+8, ...; the 8 warp sums are then added in warp
//   order after `seed`), so the result is the same from run to run. No
//   atomics.
//
// What bounds it: bytes. It reads rows * 4096 bytes once and does one add
// per element, far below the card's rate of operations for float32 adds.
// The design keeps every SM's share of the stream in flight (two blocks of
// two 32 KB stages per SM) and adds only the partials' traffic (nblocks x
// 32 KB written and read back, which stays in L2) to the input bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 1024;
constexpr int kTileRows = 8;
constexpr int kThreads = 256;
constexpr int kTileVec = kTileRows * kCols / 4;     // float4s in a tile: 2048
constexpr int kVecPerThread = kTileVec / kThreads;  // 8: one per tile row
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * kTileVec * 16;  // 64 KiB
constexpr int kTeams = kThreads / 32;               // pass 2: warps per block

static_assert(kVecPerThread == kTileRows,
              "thread t owns float4 column t of each tile row");

__device__ __forceinline__ void cp_async_16(float4* smem, const float4* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All committed groups but the newest one have landed.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void issue_tile(float4* stage, const float4* x,
                                           long long tile, int t) {
  const float4* src = x + tile * kTileVec;
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    cp_async_16(stage + t + k * kThreads, src + t + k * kThreads);
  }
}

__global__ void __launch_bounds__(kThreads)
dma_read_partial(const float4* __restrict__ x, long long tiles,
                 float4* __restrict__ partials) {
  extern __shared__ float4 stages[];  // [kStages][kTileVec]
  const int t = threadIdx.x;
  const long long first = tiles * blockIdx.x / gridDim.x;
  const long long last = tiles * (blockIdx.x + 1) / gridDim.x;

  float4 acc[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Prologue: tiles first and first+1 in flight. Every step commits one
  // group, empty past the end, so "all but the newest group" always means
  // "everything up to the tile about to be summed".
  if (first < last) issue_tile(stages, x, first, t);
  cp_async_commit();
  if (first + 1 < last) issue_tile(stages + kTileVec, x, first + 1, t);
  cp_async_commit();

  for (long long tile = first; tile < last; ++tile) {
    const int cur = static_cast<int>((tile - first) & 1);
    float4* stage = stages + cur * kTileVec;
    cp_async_wait_all_but_one();
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      const float4 v = stage[t + k * kThreads];
      acc[k].x += v.x;
      acc[k].y += v.y;
      acc[k].z += v.z;
      acc[k].w += v.w;
    }
    // Refill the stage just summed with tile+2. Only this thread read these
    // words, and its reads precede the copy in program order.
    if (tile + 2 < last) issue_tile(stage, x, tile + 2, t);
    cp_async_commit();
  }

  float4* p = partials + static_cast<long long>(blockIdx.x) * kTileVec;
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) p[t + k * kThreads] = acc[k];
}

// One block per 32 output elements; warp w sums blocks w, w+kTeams, ...
__global__ void __launch_bounds__(kThreads)
dma_read_finish(const float* __restrict__ partials, int nblocks,
                const float* __restrict__ seed, float* __restrict__ out) {
  __shared__ float team[kTeams][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  for (int b = warp; b < nblocks; b += kTeams) {
    s += partials[static_cast<long long>(b) * (kTileRows * kCols) + i];
  }
  team[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float total = *seed;
#pragma unroll
    for (int w = 0; w < kTeams; ++w) total += team[w][lane];
    out[i] = total;
  }
}

}  // namespace

// x: f32 [rows, 1024], contiguous, 16-byte aligned, rows % 8 == 0.
// seed: f32 [1]. partials: f32 [nblocks, 8, 1024] scratch. out: f32 [8, 1024].
// 1 <= nblocks <= rows / 8. Launches on `stream`; does not synchronise.
// Returns the CUDA error code (0 on success).
extern "C" int ko_dma_read(const float* x, long long rows, const float* seed,
                           float* partials, int nblocks, float* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      dma_read_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_read_partial<<<nblocks, kThreads, kSmemBytes, s>>>(
      reinterpret_cast<const float4*>(x), rows / kTileRows,
      reinterpret_cast<float4*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_read_finish<<<kTileRows * kCols / 32, kThreads, 0, s>>>(
      partials, nblocks, seed, out);
  return static_cast<int>(cudaGetLastError());
}
