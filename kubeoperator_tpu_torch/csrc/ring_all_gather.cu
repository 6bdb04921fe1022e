// K2: explicit one-direction neighbour ring all-gather (sm_90a).
//
// Replaces kubeoperator_tpu/ops/pallas_kernels.py::_ring_all_gather_kernel
// (the `pl.pallas_call`s in `ring_all_gather` and `bench_ring_all_gather`).
// Function: rank r of n holds local[r], [chunk, 1024]; at the end every
// rank's out[r], [n * chunk, 1024], is the concatenation of all shards, bit
// for bit. The kernel moves bytes and does no arithmetic, so one body serves
// every element type: it copies 16-byte vectors (uint4).
//
// Protocol, step for step the TPU kernel's:
//   1. copy local[r] into out[r * chunk] and into comm[r][0];
//   2. for i in 0 .. n-2:
//      (a) i > 0: wait until the right neighbour has finished step i-1; its
//          slot (i-1) % 2 is the slot this rank writes next (`ready_sem`);
//      (b) push comm[r][i % 2] into comm[right][(i + 1) % 2];
//      (c) release-store the right neighbour's receive flag, acquire-wait on
//          this rank's own, then copy comm[r][(i + 1) % 2] to out[src * chunk]
//          with src = (r - i - 1) mod n;
//      (d) signal the left neighbour's ready flag.
//
// Design. Each rank is a group of B blocks; block b of every rank owns the
// same element range of a chunk, so flags are per (rank, block) and no block
// ever waits on another block of its own rank. The kernel reads a table of
// per-rank pointers passed by value: one entry per rank of this launch (all
// n ranks on one card, or this process's one rank when each process drives
// one card and the peers' slots and flags are mapped into its address
// space). Flags are monotonic 64-bit counters: step i of launch `epoch`
// stores epoch * n + i + 1, so nothing is reset between launches. Waits and
// signals are system-scope acquire/release, so the same body is right across
// NVLink. Step 0 waits for the right neighbour's last signal of the previous
// launch when the caller says there was one: only then may this rank write
// into its comm slots again (one process per card, where launches of
// different ranks overlap).
//
// Safety. Blocks spin on each other, so the host launches cooperatively
// (cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident).
// A wait that spins past `timeout_ns` on %globaltimer, or sees the error word
// set by another block, writes the error word (first writer wins) and ends
// its block; the wrapper reads the word at its readbacks and raises.
//
// What bounds it: bytes. On one card the least traffic for the result is
// (n^2 + n) * chunk bytes (n outputs of n chunks written, each shard read
// once); the ring's own protocol moves about 4 n^2 * chunk (each step pushes
// a chunk and copies one out, each a read and a write). Across cards the
// bound is (n - 1) * chunk bytes over one NVLink direction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 256;
constexpr int kPtrsPerRank = 10;

struct RankTable {
  const uint4* local;              // [chunk_vec]
  uint4* out;                      // [n * chunk_vec]
  uint4* comm[2];                  // this rank's two comm slots
  uint4* right_comm[2];            // the right neighbour's two comm slots
  unsigned long long* recv;        // this rank's receive flags [B]
  unsigned long long* right_recv;  // the right neighbour's receive flags [B]
  unsigned long long* ready;       // this rank's ready flags [B]
  unsigned long long* left_ready;  // the left neighbour's ready flags [B]
};
static_assert(sizeof(RankTable) == kPtrsPerRank * sizeof(void*),
              "the host passes kPtrsPerRank pointers per rank");

struct RingTable {
  RankTable rank[kMaxRanks];
};

// Error word: (rank + 1) << 16 | (step + 1) << 4 | kind.
constexpr int kWaitReady = 1;
constexpr int kWaitRecv = 2;

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag >= target; every thread learns whether the
// wait was abandoned. The barrier at the end publishes the acquire to the
// whole block.
__device__ bool wait_geq(const unsigned long long* flag,
                         unsigned long long target, int* err, int code,
                         long long timeout_ns, int* s_abort) {
  if (threadIdx.x == 0) {
    int abort = 0;
    const unsigned long long t0 = global_timer_ns();
    while (ld_acquire_sys(flag) < target) {
      if (*reinterpret_cast<volatile int*>(err) != 0) {
        abort = 1;
        break;
      }
      if (static_cast<long long>(global_timer_ns() - t0) > timeout_ns) {
        atomicCAS(err, 0, code);
        abort = 1;
        break;
      }
      __nanosleep(64);
    }
    *s_abort = abort;
  }
  __syncthreads();
  return *s_abort != 0;
}

// All threads' prior reads and writes of this step, then one release store.
__device__ __forceinline__ void signal_flag(unsigned long long* flag,
                                            unsigned long long value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(flag, value);
  }
}

__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(RingTable table, int n, int first_rank,
                       int blocks_per_rank, long long chunk_vec,
                       unsigned long long base, int wait_prev,
                       long long timeout_ns, int* err) {
  __shared__ int s_abort;
  const int local = blockIdx.x / blocks_per_rank;
  const int b = blockIdx.x % blocks_per_rank;
  const int rank = first_rank + local;
  const RankTable& t = table.rank[local];
  const long long lo = chunk_vec * b / blocks_per_rank;
  const long long hi = chunk_vec * (b + 1) / blocks_per_rank;
  const int tid = threadIdx.x;

  // 1. own shard. The same thread pushes the same index at step 0, so no
  //    barrier is needed between the two.
  uint4* own_out = t.out + static_cast<long long>(rank) * chunk_vec;
  for (long long v = lo + tid; v < hi; v += kThreads) {
    const uint4 x = t.local[v];
    own_out[v] = x;
    t.comm[0][v] = x;
  }

  for (int i = 0; i < n - 1; ++i) {
    const int send = i & 1;
    const int recv = send ^ 1;
    // (a) the right neighbour has finished step i-1 (or, at step 0, the
    //     previous launch): its slot `recv` is free to overwrite
    //     (its step i-1 signal is base + i; its last signal of the previous
    //     launch, step n-2 of epoch - 1, is base - 1)
    if (i > 0 || wait_prev) {
      const unsigned long long target = i > 0 ? base + i : base - 1;
      if (wait_geq(t.ready + b, target, err,
                   (rank + 1) << 16 | (i + 1) << 4 | kWaitReady, timeout_ns,
                   &s_abort)) {
        return;
      }
    }
    // (b) push this block's range of the send slot to the right neighbour
    const uint4* src_slot = t.comm[send];
    uint4* dst_slot = t.right_comm[recv];
    for (long long v = lo + tid; v < hi; v += kThreads) {
      dst_slot[v] = src_slot[v];
    }
    // (c) tell the right neighbour, then wait for the left one's push
    signal_flag(t.right_recv + b, base + i + 1);
    if (wait_geq(t.recv + b, base + i + 1, err,
                 (rank + 1) << 16 | (i + 1) << 4 | kWaitRecv, timeout_ns,
                 &s_abort)) {
      return;
    }
    const int src = (rank - i - 1 + n) % n;
    const uint4* in_slot = t.comm[recv];
    uint4* dst_out = t.out + static_cast<long long>(src) * chunk_vec;
    for (long long v = lo + tid; v < hi; v += kThreads) {
      dst_out[v] = in_slot[v];
    }
    // (d) this rank is done with step i: its slot `send` may be refilled
    signal_flag(t.left_ready + b, base + i + 1);
  }
}

}  // namespace

// Largest grid the device can hold co-resident (blocks per SM x SMs) for
// this kernel at kThreads threads. Returns the CUDA error code.
extern "C" int ko_ring_max_coresident_blocks(int device, int* out) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_all_gather_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * per_sm;
  return 0;
}

// ptrs: nlocal * 10 device pointers in RankTable order, ranks first_rank ..
// first_rank + nlocal - 1. chunk_vec: 16-byte vectors per chunk. base:
// epoch * n of this launch. wait_prev: 1 if a launch with epoch - 1 ran on
// the same flags. err: device int, 0 on entry. Launches cooperatively on
// `stream` with nlocal * blocks_per_rank blocks; does not synchronise.
// Returns the CUDA error code (0 on success).
extern "C" int ko_ring_all_gather(void* const* ptrs, int nlocal, int n,
                                  int first_rank, int blocks_per_rank,
                                  long long chunk_vec, unsigned long long base,
                                  int wait_prev, long long timeout_ns,
                                  int* err, void* stream) {
  if (nlocal < 1 || nlocal > kMaxRanks || n < 1 || n > kMaxRanks ||
      blocks_per_rank < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTable table = {};
  for (int r = 0; r < nlocal; ++r) {
    void* const* p = ptrs + r * kPtrsPerRank;
    RankTable& t = table.rank[r];
    t.local = static_cast<const uint4*>(p[0]);
    t.out = static_cast<uint4*>(p[1]);
    t.comm[0] = static_cast<uint4*>(p[2]);
    t.comm[1] = static_cast<uint4*>(p[3]);
    t.right_comm[0] = static_cast<uint4*>(p[4]);
    t.right_comm[1] = static_cast<uint4*>(p[5]);
    t.recv = static_cast<unsigned long long*>(p[6]);
    t.right_recv = static_cast<unsigned long long*>(p[7]);
    t.ready = static_cast<unsigned long long*>(p[8]);
    t.left_ready = static_cast<unsigned long long*>(p[9]);
  }
  void* args[] = {&table,    &n,         &first_rank, &blocks_per_rank,
                  &chunk_vec, &base,     &wait_prev,  &timeout_ns,
                  &err};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_all_gather_kernel),
      dim3(nlocal * blocks_per_rank), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
