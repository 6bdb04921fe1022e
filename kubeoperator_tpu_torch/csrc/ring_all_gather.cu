// K2: explicit one-direction neighbour ring all-gather (sm_90a).
//
// Replaces kubeoperator_tpu/ops/pallas_kernels.py::_ring_all_gather_kernel
// (the `pl.pallas_call`s in `ring_all_gather` and `bench_ring_all_gather`).
// Function: rank r of n holds local[r], [chunk, 1024]; at the end every
// rank's out[r], [n * chunk, 1024], is the concatenation of all shards, bit
// for bit. The kernel moves bytes and does no arithmetic, so one body serves
// every element type: it copies 16-byte vectors (uint4).
//
// The ring is the TPU kernel's: rank r sends only to rank r+1, each link
// carries the n-1 foreign chunks once, and at step i rank r receives chunk
// src = (r - i - 1) mod n. At step i rank r forwards the chunk it holds,
// c = (r - i) mod n: its own shard (read from `local`) at i = 0, then the
// chunk it received at step i-1.
//
// Two forms run two landing protocols through one body (template kCrossCard):
//
//   one card, n ranks in one launch (kCrossCard = false). A rank writes the
//     chunk straight into the right neighbour's output, out[right][c], and
//     forwards it next step from its own out[r][c]: no comm slots and no
//     copy-out. Step 0 reads local[r] once and writes out[r][r] and
//     out[right][r]. Every step lands in a region of out[right] that no
//     step of the launch writes again, so nothing is overwritten that its
//     reader still needs and the only wait is the receive wait. (Mosaic
//     needs `ready_sem` because its 2-slot comm buffer is reused.)
//     Device-memory traffic: n(2n-1) chunk reads and writes, against the
//     bound's n + n^2 (each shard read once, n outputs of n chunks
//     written); the forwarded reads are meant to hit L2 (below).
//   one process per card (kCrossCard = true). The output of a peer is not
//     mapped, so a rank pushes into the right neighbour's 2-slot landing
//     buffer (symmetric memory): step i fills slot (i + 1) % 2, and the
//     receiver reads each landed piece once, writing it to out[src] and, if
//     a step remains, to the next neighbour's slot. Slots are reused, so a
//     push at step i >= 2 waits until the receiver has read that slot's
//     piece (the ready wait), and the first push of a launch waits until
//     the receiver has read everything of its previous launch (launches of
//     different processes overlap). Pushing into the peer's output instead
//     would need a symmetric buffer as large as the output and a local
//     copy to hand the caller its tensor.
//
// Pieces. Block b of every rank owns the same range [lo, hi) of a chunk's
// vectors, split into `pieces` pieces (same count for every block; the
// split is ring_gather.piece_plan's). A block takes piece p through every
// step before piece p+1, and signals a per-(rank, block) counter after each
// piece, so block b of rank r+1 forwards piece p right after it lands,
// while it is still in L2: the bytes written and not yet forwarded are
// about (blocks in the grid) x (piece size), well inside the 50 MB L2, and
// the ring runs as a pipeline rather than in lockstep steps of whole chunks.
//
// Counters are monotonic u64: (piece p, step i) of a launch is event
// k = p * n + i, signalled as base + k + 1, and the host advances `base` by
// pieces * n per launch, so nothing is reset between launches. A block's
// last ready signal of a launch is then exactly the next launch's base.
//
// Scopes. One card: __threadfence() and st.release.gpu / ld.acquire.gpu.
// Across cards: __threadfence_system() and .sys, so the order holds over
// NVLink.
//
// Safety. Blocks spin on each other, so the host launches cooperatively
// (cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident).
// A wait that spins past `timeout_ns` on %globaltimer, or sees the error word
// set by another block, writes the error word (first writer wins) and ends
// its block; the wrapper reads the word at its readbacks and raises.
//
// What bounds it: bytes. On one card (n^2 + n) * chunk bytes over the
// memory rate; across cards (n - 1) * chunk bytes over one NVLink direction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread has in flight per pass
constexpr int kPtrsPerRank = 8;

struct RankTable {
  const uint4* local;              // [chunk_vec]
  uint4* out;                      // [n * chunk_vec]
  const uint4* hold;               // where received chunks are read back
  uint4* right_land;               // where this rank's pushes land
  unsigned long long* recv;        // this rank's receive counters [B]
  unsigned long long* right_recv;  // the right neighbour's [B]
  unsigned long long* ready;       // this rank's ready counters [B]
  unsigned long long* left_ready;  // the left neighbour's [B]
};
static_assert(sizeof(RankTable) == kPtrsPerRank * sizeof(void*),
              "the host passes kPtrsPerRank pointers per rank");

struct RingTable {
  RankTable rank[kMaxRanks];
};

// Error word: (piece + 1) << 32 | (rank + 1) << 16 | (step + 1) << 8 | kind.
constexpr unsigned long long kWaitReady = 1;
constexpr unsigned long long kWaitRecv = 2;
constexpr unsigned long long kWaitPrevLaunch = 3;

__device__ __forceinline__ unsigned long long error_code(
    int rank, int step, long long piece, unsigned long long kind) {
  return static_cast<unsigned long long>(piece + 1) << 32 |
         static_cast<unsigned long long>(rank + 1) << 16 |
         static_cast<unsigned long long>(step + 1) << 8 | kind;
}

template <bool kSys>
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  if (kSys) {
    asm volatile("ld.acquire.sys.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  }
  return v;
}

template <bool kSys>
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  if (kSys) {
    asm volatile("st.release.sys.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
  } else {
    asm volatile("st.release.gpu.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
  }
}

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag >= target; every thread learns whether the
// wait was abandoned. The barrier at the end publishes the acquire to the
// whole block.
template <bool kSys>
__device__ bool wait_geq(const unsigned long long* flag,
                         unsigned long long target, unsigned long long* err,
                         unsigned long long code, long long timeout_ns,
                         int* s_abort) {
  if (threadIdx.x == 0) {
    int abort = 0;
    if (ld_acquire<kSys>(flag) < target) {
      const unsigned long long t0 = global_timer_ns();
      while (ld_acquire<kSys>(flag) < target) {
        if (*reinterpret_cast<volatile unsigned long long*>(err) != 0) {
          abort = 1;
          break;
        }
        if (static_cast<long long>(global_timer_ns() - t0) > timeout_ns) {
          atomicCAS(err, 0ull, code);
          abort = 1;
          break;
        }
        __nanosleep(32);
      }
    }
    *s_abort = abort;
  }
  __syncthreads();
  return *s_abort != 0;
}

// Every thread's writes of this piece, then one release store per flag
// (a null flag is skipped).
template <bool kSys>
__device__ __forceinline__ void signal(unsigned long long* a,
                                       unsigned long long* b,
                                       unsigned long long value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kSys) {
      __threadfence_system();
    } else {
      __threadfence();
    }
    if (a != nullptr) st_release<kSys>(a, value);
    if (b != nullptr) st_release<kSys>(b, value);
  }
}

// Copies src[lo, hi) to d0 and, if not null, d1. What makes received bytes
// (written by another SM or card) visible here is the caller's wait_geq:
// thread 0's ld.acquire of the counter, then the block barrier; the loads
// below carry no ordering of their own. `.cs` (`__ldcs`, `__stcs`) is only
// a cache hint, evict-first: every byte is read once in a launch, and d0
// is the final output. d1 is a push, kept in L2 (`.cg`) when `forwarded`
// says the receiver reads it again next step. Evict-first reads measured
// faster on an H100 than `.cg` reads (kernel_sweep.py; PERF.md).
__device__ __forceinline__ void copy_piece(const uint4* src, uint4* d0,
                                           uint4* d1, bool forwarded,
                                           long long lo, long long hi) {
  for (long long v = lo + threadIdx.x; v < hi; v += kUnroll * kThreads) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = v + u * kThreads;
      if (w < hi) x[u] = __ldcs(src + w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = v + u * kThreads;
      if (w < hi) {
        if (d0 != nullptr) __stcs(d0 + w, x[u]);
        if (d1 != nullptr) {
          if (forwarded) {
            __stcg(d1 + w, x[u]);
          } else {
            __stcs(d1 + w, x[u]);
          }
        }
      }
    }
  }
}

template <bool kCrossCard>
__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(RingTable table, int n, int first_rank,
                       int blocks_per_rank, long long chunk_vec, int pieces,
                       unsigned long long base, long long timeout_ns,
                       unsigned long long* err) {
  __shared__ int s_abort;
  const int local = blockIdx.x / blocks_per_rank;
  const int b = blockIdx.x % blocks_per_rank;
  const int rank = first_rank + local;
  const RankTable& t = table.rank[local];
  // ring_gather.piece_plan: block b's range, then its `pieces` pieces
  const long long lo = chunk_vec * b / blocks_per_rank;
  const long long len = chunk_vec * (b + 1) / blocks_per_rank - lo;
  // one card: the last push is step n-2 (step 0 also writes the own shard,
  // so it runs at n = 1 too); with slots, step n-1 reads the last landing
  const int last_step = kCrossCard ? n - 1 : (n > 1 ? n - 2 : 0);

  // across cards: the right neighbour has read every piece this block
  // pushed into its slots in the previous launch (its last ready signal)
  if (kCrossCard &&
      wait_geq<true>(t.ready + b, base, err,
                     error_code(rank, 0, 0, kWaitPrevLaunch), timeout_ns,
                     &s_abort)) {
    return;
  }

  for (int p = 0; p < pieces; ++p) {
    const long long plo = lo + len * p / pieces;
    const long long phi = lo + len * (p + 1) / pieces;
    const unsigned long long event0 = base + static_cast<unsigned long long>(p) * n;
    for (int i = 0; i <= last_step; ++i) {
      const int c = (rank - i + n) % n;  // the chunk this rank holds at step i
      const bool push = i <= n - 2;
      const uint4* src = t.local;
      if (i > 0) {
        // the left neighbour's push of (piece p, step i-1) has landed
        if (wait_geq<kCrossCard>(t.recv + b, event0 + i, err,
                                 error_code(rank, i, p, kWaitRecv), timeout_ns,
                                 &s_abort)) {
          return;
        }
        src = t.hold + (kCrossCard ? (i & 1) * chunk_vec : c * chunk_vec);
      }
      if (kCrossCard && push && i >= 2) {
        // the right neighbour has read (piece p, step i-2) from the slot
        // this push fills
        if (wait_geq<true>(t.ready + b, event0 + i, err,
                           error_code(rank, i, p, kWaitReady), timeout_ns,
                           &s_abort)) {
          return;
        }
      }
      // one card: the output is written at step 0 only (later chunks land
      // in it from the left); with slots, every step writes out[c]
      uint4* own = (kCrossCard || i == 0) ? t.out + c * chunk_vec : nullptr;
      uint4* land = nullptr;
      if (push) {
        land = t.right_land +
               (kCrossCard ? ((i + 1) & 1) * chunk_vec : c * chunk_vec);
      }
      // the receiver forwards what lands before step n-2 (one card); with
      // slots it reads every landing once more
      copy_piece(src, own, land, kCrossCard || i < n - 2, plo, phi);
      signal<kCrossCard>(push ? t.right_recv + b : nullptr,
                         kCrossCard && i > 0 ? t.left_ready + b : nullptr,
                         event0 + i + 1);
    }
  }
}

template <bool kCrossCard>
int max_coresident(int device, int* out) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_all_gather_kernel<kCrossCard>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * per_sm;
  return 0;
}

}  // namespace

// Largest grid the device can hold co-resident (blocks per SM x SMs) for
// the form's kernel at kThreads threads. Returns the CUDA error code.
extern "C" int ko_ring_max_coresident_blocks(int device, int cross_card,
                                             int* out) {
  return cross_card ? max_coresident<true>(device, out)
                    : max_coresident<false>(device, out);
}

// ptrs: nlocal * 8 device pointers in RankTable order, ranks first_rank ..
// first_rank + nlocal - 1 (the one-card form passes null ready pointers).
// chunk_vec: 16-byte vectors per chunk. pieces: pieces per block. base: the
// launch's counter base (the previous launch's base + pieces * n). err:
// device u64, 0 on entry. Launches cooperatively on `stream` with
// nlocal * blocks_per_rank blocks; does not synchronise. Returns the CUDA
// error code (0 on success).
extern "C" int ko_ring_all_gather(void* const* ptrs, int nlocal, int n,
                                  int first_rank, int blocks_per_rank,
                                  long long chunk_vec, int pieces,
                                  unsigned long long base, int cross_card,
                                  long long timeout_ns,
                                  unsigned long long* err, void* stream) {
  if (nlocal < 1 || nlocal > kMaxRanks || n < 1 || n > kMaxRanks ||
      blocks_per_rank < 1 || pieces < 1 || (cross_card && n < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTable table = {};
  for (int r = 0; r < nlocal; ++r) {
    void* const* p = ptrs + r * kPtrsPerRank;
    RankTable& t = table.rank[r];
    t.local = static_cast<const uint4*>(p[0]);
    t.out = static_cast<uint4*>(p[1]);
    t.hold = static_cast<const uint4*>(p[2]);
    t.right_land = static_cast<uint4*>(p[3]);
    t.recv = static_cast<unsigned long long*>(p[4]);
    t.right_recv = static_cast<unsigned long long*>(p[5]);
    t.ready = static_cast<unsigned long long*>(p[6]);
    t.left_ready = static_cast<unsigned long long*>(p[7]);
  }
  void* args[] = {&table,  &n,    &first_rank, &blocks_per_rank, &chunk_vec,
                  &pieces, &base, &timeout_ns, &err};
  const void* fn =
      cross_card ? reinterpret_cast<const void*>(ring_all_gather_kernel<true>)
                 : reinterpret_cast<const void*>(ring_all_gather_kernel<false>);
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(nlocal * blocks_per_rank), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
