// K3: fused causal attention of the dense stage, forward and backward (sm_90a).
//
// Replaces no TPU kernel: the JAX package's workloads/step.py::_forward
// writes this chain as plain jnp and leaves it to XLA's fusion. On the card
// the eager chain wrote [b, h, s, s] f32 scores to device memory and swept
// them about a dozen times forward and back. These kernels keep each tile
// of scores in registers. `ops/attention.py` holds the wrapper, the plain
// version and the dispatch.
//
// Function, for bf16 q, k [b, s, h, DQK] and v [b, s, h, DV] (head columns
// contiguous; at equal widths one set of strides for all three, at two
// widths each its own) at a pair of head widths the library is built for:
//
//     S = bf16(q·kᵀ) / sqrt(dh)   (f32 sums, rounded to bf16, widened, then
//                                  divided as a correctly rounded f32 division)
//     S[m, n] = -1e30 where n > m
//     o = bf16(bf16(exp(S - max)) · v / sum),  lse = max + log(sum)   (f32)
//
// and its gradients: D = rowsum(dO∘o) (f32), P = exp(S - lse),
// dS = bf16(P∘(dO·vᵀ - D) / sqrt(dh)), dq = dS·k, dk = dSᵀ·q, dv = bf16(P)ᵀ·dO.
// Widths: DQK = DV = dh in 64, 128, 256, 512 (the dense stage); and DQK 192,
// DV 128 (latent attention: 128 columns without position and 64 rotated),
// where the instantiation's SCALE replaces the division by a product with a
// given softmax scale, S = bf16(q·kᵀ)·scale and dS = bf16(P∘(dO·vᵀ - D)·scale),
// each one f32 multiply as the chain's.
//
// Launches. Forward: one (kind kFwd), writing o and lse. Backward: four, with
// no atomics, so the gradients are the same bits from run to run: D
// (delta_kernel), then dV and dK (kinds kDv and kDk: one block per 64-row K
// tile, walking the Q tiles from the diagonal down) and dQ (kind kDq: one
// block per 64-row Q tile, walking the K tiles up to the diagonal).
//
// What bounds it on the H100. Forward is two b·h·s²·dh products over the
// causal half, backward eight (S recomputed in each of dV, dK and dQ; dP in
// dK and dQ; then bf16(P)ᵀ·dO, dSᵀ·q and dS·k). At dh = 512 a score costs
// 1024 multiply-adds against a few dozen instructions of softmax, so the
// work is the tensor cores'. What holds them back is feeding them: a block
// re-reads every K/V (or Q/dO) tile of its walk from L2, 128 KB a tile for
// 8.4 MFLOP in kFwd and kDv, and the block works in lock step (products,
// then the softmax while the tensor cores idle, then products).
//
// Design. Every kind is one shape: a block holds a 64-row tile (A1, and A2
// where there are two score products) in shared memory and an f32
// accumulator [64, DH] in registers, and streams tiles (B1, B2) of kBn rows
// through shared memory with cp.async. Per streamed tile it forms scores
// A1·B1ᵀ (and A2·B2ᵀ) with wgmma (both operands in shared memory, K-major;
// bf16 in, f32 sums), turns them into a bf16 tile in registers (the
// accumulator fragment of one product is the register A fragment of the
// next), and adds that tile times C (B2 for kFwd and kDv, B1 for kDk and
// kDq; MN-major in shared memory) into the accumulator with wgmma.
//   fwd: A1 = q,  B1 = k,  B2 = v,  C = v       acc = o
//   dV:  A1 = k,  B1 = q,  B2 = dO, C = dO      acc = dv
//   dK:  A1 = k,  A2 = v,  B1 = q,  B2 = dO, C = q   acc = dk
//   dQ:  A1 = q,  A2 = dO, B1 = k,  B2 = v,  C = k   acc = dq
// With two widths, held and streamed tiles of q and k (and of dq's C) take
// DQK columns and those of v and dO DV; the accumulator takes C's width.
// dh = 512 sets the tiles: a [64, 512] f32 accumulator is 128 KB, half the
// register file, so at that width two warpgroups share it: warpgroup c owns
// dh columns 256c..256c+255 of all 64 rows (warp r of it rows 16r..16r+15).
// The two warpgroups each sum the scores over their own half of dh and
// trade the partial sums through shared memory (a + b in both, the same
// bits), so no score is computed twice. Narrower widths run one warpgroup
// owning all columns. Tiles lie in shared memory as blocks of 64 columns
// with 128-byte rows, swizzled by 16-byte chunk (chunk ^ row % 8): the
// layout wgmma reads with 128-byte swizzle. One buffer a streamed tile,
// refilled as soon as the block is done with it: kFwd and kDv stream 64-row
// tiles (shared memory at dh = 512: 64 KB held, 128 KB streamed, 32 KB of
// partial sums), kDk and kDq, holding two tiles, 32-row ones (128 + 64 +
// 32 KB) and read B2 for dP while B1 arrives. One block an SM at dh = 512.
// K/V tiles wholly above the diagonal are never loaded; only the tiles the
// diagonal crosses are masked (exact: exp(-1e30 - max) is 0 in f32).
//
// Rounding points: the chain's, except one a one-pass kernel cannot keep:
// the chain normalises P before its cast to bf16, the kernel divides the f32
// sum of P·v by the row's sum after it. The division by sqrt(dh) is
// t = x·r, then t + fma(-t, root, x)·r with r the f32 nearest 1/root: the
// correctly rounded quotient for |x| >= 2^-100 (ops/attention.py::divisor).
// exp is ex2.approx of x·log2(e); nothing drops to fp8 or TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;    // rows of the held tile: 4 row groups of 16
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;

enum Kind { kFwd = 0, kDv = 1, kDk = 2, kDq = 3 };

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;   // dO, [b, s, h, DV] contiguous (backward)
  const float* lse;            // [b, h, s] (backward)
  const float* delta;          // [b, h, s] (kDk, kDq)
  __nv_bfloat16* out;          // o, dv: [b, s, h, DV]; dq, dk: [b, s, h, DQK]
  float* lse_out;              // [b, h, s] (forward)
  long long sqb, sqs, sqh;     // q strides in elements (k and v too at equal widths)
  int bh, heads, seq;
  float root, rinv;            // sqrt(dh) and its reciprocal; the scale in rinv with SCALE
};

// two widths: k's and v's own strides too (a kernel of equal widths takes
// Args alone, whose size its register allocation depends on)
struct PairArgs : Args {
  long long skb, sks, skh;
  long long svb, svs, svh;
};

template <int DQK, int DV>
using ArgsOf = std::conditional_t<DQK == DV, Args, PairArgs>;

template <int KIND, int DQK, int DV>
struct Plan {
  static constexpr int kWn = DQK == 512 ? 2 : 1;  // warps sharing the columns
  static constexpr int kWarps = 4 * kWn;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr bool kTwo = KIND == kDk || KIND == kDq;
  // the accumulator's width: o and dv take v's, dq and dk q's
  static constexpr int kAcc = kTwo ? DQK : DV;
  static constexpr int kCols = kAcc / kWn;         // accumulator columns of a warp
  static constexpr int kColsQk = DQK / kWn;        // summed columns of q·kᵀ, dS·k
  static constexpr int kColsV = DV / kWn;          // summed columns of dO·vᵀ
  // rows of a streamed tile: 64, or 32 where two held tiles leave less room
  static constexpr int kBn = kTwo ? 32 : 64;
  // held tiles: A1 (DQK columns), A2 (DV columns, kDk and kDq); streamed
  // tiles: B1 (DQK columns), B2 (DV columns)
  static constexpr int kHeldBytes = kBM * DQK * 2;
  static constexpr int kTileBytes = kBn * DQK * 2;
  static constexpr int kHeld = kHeldBytes + (kTwo ? kBM * DV * 2 : 0);
  static constexpr int kStage = kTileBytes + kBn * DV * 2;
  static constexpr int kPartial = kWarps * 16 * kBn * 4;   // one score product
  static constexpr int kTrade = kWn > 1 ? (kTwo ? 2 : 1) * kPartial : 0;
  // + 1 KB to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmem = kHeld + kStage + kTrade + 1024;
  static_assert(kSmem <= kMaxSmem, "tiles exceed shared memory");
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "tiles are blocks of 64 columns");
  static_assert(kWn == 1 || DQK == DV, "two warpgroups split one width");
};

// byte offset of 16-byte chunk `chunk` of row `row` in a ROWS-row tile:
// blocks of 64 columns (ROWS x 128 bytes each), chunks swizzled by row
// (chunk ^ row % 8), the layout wgmma reads as 128-byte swizzled (K-major
// for a score product's operands, MN-major for the second product's B)
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (chunk >> 3) * (ROWS * 128) + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// a shared memory matrix descriptor: 128-byte swizzle, byte offsets `lbo`
// (between 64-column blocks of an MN-major operand) and `sbo` (between
// 8-row groups)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 32, f32) = (scale ? d : 0) + A·Bᵀ, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                            int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale));
}

// d (64 x 64, f32) = (scale ? d : 0) + A·Bᵀ, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale));
}

// d (64 x 64, f32) += A·B, A in registers (bf16 fragments), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A·B, A in registers (bf16 fragments), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256, f32) += A·B, A in registers (bf16 fragments), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n64(d, a, b);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async's writes made visible to wgmma's reads of shared memory
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// x / root, correctly rounded (see the header)
__device__ __forceinline__ float divide(float x, float root, float rinv) {
  float t = __fmul_rn(x, rinv);
  return fmaf(fmaf(-t, root, x), rinv, t);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a [s, DH] slab with row stride `stride` into a
// swizzled tile; rows at or past `seq` are zero-filled
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0, int seq,
                                          int tid) {
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = row0 + r < seq;
    const __nv_bfloat16* src =
        base + (live ? (long long)(row0 + r) * stride : 0) + c * 8;
    cp_async(tile + swz<ROWS>(r, c), src, live);
  }
}

// issues s (this warp's 16 rows of a 64 x kBN score tile over the
// warpgroup) = rows of `a` (kBM rows) times rows of `b` (kBN rows), over dh
// columns [k0, k0 + KC); both operands K-major
template <int KC, int BN>
__device__ __forceinline__ void scores(float s[BN / 8][4], uint32_t a,
                                       uint32_t b, int k0) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    const int k = k0 + kk * 16;
    const uint32_t in = (k & 63) * 2;
    const uint64_t da = smem_desc(a + (k >> 6) * (kBM * 128) + in, 16, 1024);
    const uint64_t db = smem_desc(b + (k >> 6) * (BN * 128) + in, 16, 1024);
    if constexpr (BN == 64) wgmma_ss_n64(&s[0][0], da, db, kk);
    else wgmma_ss_n32(&s[0][0], da, db, kk);
  }
}

// acc (this warp's 16 rows by KC columns from c0) += p (16 x kBN, bf16
// fragments) times rows 0..kBN of `c` (MN-major); 192 columns as 128 + 64
template <int KC, int BN>
__device__ __forceinline__ void accumulate(float acc[KC / 8][4],
                                           uint32_t p[BN / 16][4],
                                           uint32_t c, int c0) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (KC == 192) {
      const uint32_t at = c + (c0 >> 6) * (BN * 128) + kk * 16 * 128;
      wgmma_rs<128>(&acc[0][0], p[kk], smem_desc(at, BN * 128, 1024));
      wgmma_rs<64>(&acc[16][0], p[kk],
                   smem_desc(at + 2 * (BN * 128), BN * 128, 1024));
    } else {
      wgmma_rs<KC>(&acc[0][0], p[kk],
                   smem_desc(c + (c0 >> 6) * (BN * 128) + kk * 16 * 128,
                             BN * 128, 1024));
    }
  }
  wg_commit_and_wait();
}

// this warp's partial sums, for its partner to add (a + b in both warps)
template <int BN>
__device__ __forceinline__ void trade(float s[BN / 8][4], float* mine,
                                      int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    *reinterpret_cast<float4*>(mine + (j * 32 + lane) * 4) =
        make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
}

template <int BN>
__device__ __forceinline__ void add_traded(float s[BN / 8][4],
                                           const float* theirs, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float4 o =
        *reinterpret_cast<const float4*>(theirs + (j * 32 + lane) * 4);
    s[j][0] += o.x;
    s[j][1] += o.y;
    s[j][2] += o.z;
    s[j][3] += o.w;
  }
}

template <int BN>
__device__ __forceinline__ void to_fragments(float s[BN / 8][4],
                                             uint32_t p[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack(s[2 * kk][0], s[2 * kk][1]);
    p[kk][1] = pack(s[2 * kk][2], s[2 * kk][3]);
    p[kk][2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[kk][3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// S or dS from an f32 value: divided by sqrt(dh), or with SCALE multiplied
// by the scale (see the header)
template <bool SCALE>
__device__ __forceinline__ float scaled(float x, float root, float rinv) {
  if constexpr (SCALE) return __fmul_rn(x, rinv);
  else return divide(x, root, rinv);
}

template <int KIND, int DQK, int DV, bool SCALE>
__global__ void __launch_bounds__(Plan<KIND, DQK, DV>::kThreads, 1)
    attention_kernel(const ArgsOf<DQK, DV> a) {
  using P = Plan<KIND, DQK, DV>;
  constexpr int KC = P::kCols;
  constexpr int kBN = P::kBn;
  constexpr bool kHoldsQ = KIND == kFwd || KIND == kDq;
  extern __shared__ __align__(128) uint8_t raw[];
  const uint32_t raw_at = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t base = (raw_at + 1023) & ~1023u;
  uint8_t* smem = raw + (base - raw_at);
  const uint32_t held1 = base, held2 = base + P::kHeldBytes;
  // the streamed tiles: b1 feeds the (first) score product, b2 the second
  // product (kFwd, kDv) or the second score product (kDk, kDq)
  const uint32_t b1 = base + P::kHeld, b2 = b1 + P::kTileBytes;
  float* partials = reinterpret_cast<float*>(smem + P::kHeld + P::kStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.z * 65535 + blockIdx.y;
  if (bh >= a.bh) return;
  const int b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  // the held tile's first row; Q-holding kinds start with the longest walks
  const int r0 = (kHoldsQ ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBM;
  // equal widths: q, k and v share q's strides (views of one qkv product
  // or padded copies), dO and the output one layout; two widths: each its own
  constexpr bool kOne = DQK == DV;
  const long long in_off = b * a.sqb + h * a.sqh;
  const long long out_off = (long long)b * seq * a.heads * P::kAcc + h * P::kAcc;
  const long long out_row = (long long)a.heads * P::kAcc;
  const long long do_row = kOne ? out_row : (long long)a.heads * DV;
  long long sks = a.sqs, svs = a.sqs;
  const __nv_bfloat16* qg = a.q + in_off;
  const __nv_bfloat16* kg = a.k + in_off;
  const __nv_bfloat16* vg = a.v + in_off;
  if constexpr (!kOne) {
    sks = a.sks;
    svs = a.svs;
    kg = a.k + b * a.skb + h * a.skh;
    vg = a.v + b * a.svb + h * a.svh;
  }
  const __nv_bfloat16* dg =
      a.dout + (kOne ? out_off : (long long)b * seq * do_row + h * DV);

  // held tiles and streamed slabs, by kind
  const __nv_bfloat16 *h1, *h2 = nullptr, *s1, *s2;
  long long h1s, h2s = 0, s1s, s2s;
  if (KIND == kFwd) {
    h1 = qg; h1s = a.sqs; s1 = kg; s1s = sks; s2 = vg; s2s = svs;
  } else if (KIND == kDv) {
    h1 = kg; h1s = sks; s1 = qg; s1s = a.sqs; s2 = dg; s2s = do_row;
  } else if (KIND == kDk) {
    h1 = kg; h1s = sks; h2 = vg; h2s = svs;
    s1 = qg; s1s = a.sqs; s2 = dg; s2s = do_row;
  } else {
    h1 = qg; h1s = a.sqs; h2 = dg; h2s = do_row;
    s1 = kg; s1s = sks; s2 = vg; s2s = svs;
  }
  // streamed tiles: K/V from 0 up to the diagonal, or Q/dO from it down
  const int first = kHoldsQ ? 0 : r0;
  const int last = kHoldsQ ? min(r0 + kBM, seq) : seq;
  const int n_tiles = (last - first + kBN - 1) / kBN;

  load_tile<DQK, kBM, P::kThreads>(held1, h1, h1s, r0, seq, tid);
  if (P::kTwo) load_tile<DV, kBM, P::kThreads>(held2, h2, h2s, r0, seq, tid);
  // the operand read first goes in the older group: b1 for kFwd and kDv,
  // b2 (read by dP, while b1 arrives) for kDk and kDq
  if (!P::kTwo) load_tile<DQK, kBN, P::kThreads>(b1, s1, s1s, first, seq, tid);
  load_tile<DV, kBN, P::kThreads>(b2, s2, s2s, first, seq, tid);
  cp_commit();
  if (P::kTwo) load_tile<DQK, kBN, P::kThreads>(b1, s1, s1s, first, seq, tid);
  cp_commit();

  // per-row softmax statistics of the held rows (kFwd: running max and
  // sum; kDq: lse and D), rows 16wr + g and 16wr + g + 8
  float m_i[2], l_i[2];
  const int row[2] = {r0 + wr * 16 + g, r0 + wr * 16 + g + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (KIND == kDq) {
      m_i[i] = row[i] < seq ? a.lse[(long long)bh * seq + row[i]] : INFINITY;
      l_i[i] = row[i] < seq ? a.delta[(long long)bh * seq + row[i]] : 0.f;
    } else {
      m_i[i] = -INFINITY;
      l_i[i] = 0.f;
    }
  }
  float acc[KC / 8][4];
#pragma unroll
  for (int n = 0; n < KC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // One buffer for each streamed tile. A buffer is refilled with the next
  // tile as soon as the block is done reading it, so the copy of b1 (kFwd,
  // kDv) or b2 (kDk, kDq) runs under the rest of the tile's work. Groups of
  // copies, oldest first: b1 of tile j, b2 of tile j, b1 of j + 1, ...
  // (kDk and kDq: b2 of j before b1 of j, so dP runs while b1 arrives).
  for (int j = 0; j < n_tiles; ++j) {
    const int s0 = first + j * kBN;   // first row of the streamed tile
    const bool more = j + 1 < n_tiles;
    cp_wait<1>();
    fence_async_shared();
    __syncthreads();

    float s[kBN / 8][4] = {}, dp[kBN / 8][4] = {};
    wg_fence();
    if (P::kTwo) {
      scores<P::kColsV, kBN>(dp, held2, b2, wc * P::kColsV);
      cp_wait<0>();                   // b1 of this tile
      fence_async_shared();
      __syncthreads();
    }
    scores<P::kColsQk, kBN>(s, held1, b1, wc * P::kColsQk);
    // per column statistics of the streamed rows (kDv, kDk), read while
    // the products run
    float col_lse[kBN / 8][2], col_d[kBN / 8][2];
    if (!kHoldsQ) {
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = s0 + jn * 8 + 2 * t + e;
          const long long at = (long long)bh * seq + m;
          col_lse[jn][e] = m < seq ? __ldg(a.lse + at) : INFINITY;
          col_d[jn][e] = (KIND == kDk && m < seq) ? __ldg(a.delta + at) : 0.f;
        }
    }
    wg_commit_and_wait();
    __syncthreads();
    if (more) {
      if (P::kTwo) load_tile<DV, kBN, P::kThreads>(b2, s2, s2s, s0 + kBN, seq, tid);
      else load_tile<DQK, kBN, P::kThreads>(b1, s1, s1s, s0 + kBN, seq, tid);
    }
    cp_commit();
    if (P::kWn > 1) {
      float* mine = partials + warp * 16 * kBN;
      const float* theirs = partials + (warp ^ 4) * 16 * kBN;
      trade<kBN>(s, mine, lane);
      if (P::kTwo) trade<kBN>(dp, mine + P::kPartial / 4, lane);
      pair_barrier(1 + wr);
      add_traded<kBN>(s, theirs, lane);
      if (P::kTwo) add_traded<kBN>(dp, theirs + P::kPartial / 4, lane);
    }
    // the diagonal crosses this tile: mask the scores above it
    const bool diag = kHoldsQ ? s0 + kBN > r0 : s0 < r0 + kBM;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = scaled<SCALE>(bf16_round(s[jn][e]), a.root, a.rinv);
        const int r = row[e >> 1], c = s0 + jn * 8 + 2 * t + (e & 1);
        if (diag && (kHoldsQ ? c > r : c < r)) x = kMask;
        s[jn][e] = x;
      }

    if (KIND == kFwd) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(m_i[i], mx[i]);
        alpha[i] = fexp(m_i[i] - mx[i]);
        m_i[i] = mx[i];
      }
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] = fexp(s[jn][e] - mx[e >> 1]);
          sum[e >> 1] += s[jn][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l_i[i] = l_i[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    } else {
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse = kHoldsQ ? m_i[e >> 1] : col_lse[jn][e & 1];
          float p = fexp(s[jn][e] - lse);
          if (P::kTwo) {
            const float d = kHoldsQ ? l_i[e >> 1] : col_d[jn][e & 1];
            p = scaled<SCALE>(p * (dp[jn][e] - d), a.root, a.rinv);
          }
          s[jn][e] = p;
        }
    }
    uint32_t pf[kBN / 16][4];
    to_fragments<kBN>(s, pf);
    if (!P::kTwo) {                   // b2 of this tile
      cp_wait<1>();
      fence_async_shared();
      __syncthreads();
    }
    accumulate<KC, kBN>(acc, pf, P::kTwo ? b1 : b2, wc * KC);
    __syncthreads();
    if (more) {
      if (P::kTwo) load_tile<DQK, kBN, P::kThreads>(b1, s1, s1s, s0 + kBN, seq, tid);
      else load_tile<DV, kBN, P::kThreads>(b2, s2, s2s, s0 + kBN, seq, tid);
    }
    cp_commit();
  }

  // the accumulator, bf16, to rows r0.. of out; kFwd divides by the row's
  // sum first and writes lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= seq) continue;
    __nv_bfloat16* dst = a.out + out_off + row[i] * out_row + wc * KC + 2 * t;
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) {
      float x0 = acc[n][2 * i], x1 = acc[n][2 * i + 1];
      if (KIND == kFwd) {
        x0 = x0 / l_i[i];
        x1 = x1 / l_i[i];
      }
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack(x0, x1);
    }
    if (KIND == kFwd && wc == 0 && t == 0)
      a.lse_out[(long long)bh * seq + row[i]] = m_i[i] + logf(l_i[i]);
  }
}

// D[b, h, s] = sum over dh of o·dO in f32: one warp a (b, s, h) row
template <int DH>
__global__ void __launch_bounds__(256)
    delta_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                 float* delta, long long rows, int heads, int seq) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < DH / 8; c += 32) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + r * DH + c * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + r * DH + c * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(op[i]), y = __bfloat1622float2(dp[i]);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long bs = r / heads;   // b * seq + s
    const int h = r % heads;
    delta[((bs / seq) * heads + h) * seq + bs % seq] = sum;
  }
}

template <int KIND, int DQK, int DV, bool SCALE>
int launch(const PairArgs& a, cudaStream_t stream) {
  using P = Plan<KIND, DQK, DV>;
  // per device, so set at every launch (about a microsecond)
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<KIND, DQK, DV, SCALE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.seq + kBM - 1) / kBM, a.bh < 65535 ? a.bh : 65535,
            (a.bh + 65534) / 65535);
  attention_kernel<KIND, DQK, DV, SCALE><<<grid, P::kThreads, P::kSmem, stream>>>(
      static_cast<const ArgsOf<DQK, DV>&>(a));
  return cudaGetLastError();
}

template <int DQK, int DV, bool SCALE>
int launch_kind(int kind, const PairArgs& a, cudaStream_t stream) {
  switch (kind) {
    case kFwd: return launch<kFwd, DQK, DV, SCALE>(a, stream);
    case kDv: return launch<kDv, DQK, DV, SCALE>(a, stream);
    case kDk: return launch<kDk, DQK, DV, SCALE>(a, stream);
    case kDq: return launch<kDq, DQK, DV, SCALE>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <int KIND>
int smem_of(int dqk, int dv) {
  if (dqk == 192 && dv == 128) return Plan<KIND, 192, 128>::kSmem;
  if (dqk != dv) return -1;
  switch (dqk) {
    case 64: return Plan<KIND, 64, 64>::kSmem;
    case 128: return Plan<KIND, 128, 128>::kSmem;
    case 256: return Plan<KIND, 256, 256>::kSmem;
    case 512: return Plan<KIND, 512, 512>::kSmem;
  }
  return -1;
}

}  // namespace

extern "C" {

// One launch of kind `kind` (0 forward, 1 dV, 2 dK, 3 dQ) at head widths
// `dqk` = `dv` (64, 128, 256 or 512; S divided by `root`) or (`dqk`, `dv`) =
// (192, 128) (S times the scale `rinv`). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a kind or widths the library does not hold.
int ko_attention(int kind, int dqk, int dv, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, void* out, void* lse_out, long long sqb,
                 long long sqs, long long sqh, long long skb, long long sks,
                 long long skh, long long svb, long long svs, long long svh,
                 int batch, int heads, int seq, float root, float rinv,
                 void* stream) {
  PairArgs a{{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(lse_out),
               sqb, sqs, sqh, batch * heads, heads, seq, root, rinv},
              skb, sks, skh, svb, svs, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dqk == 192 && dv == 128) return launch_kind<192, 128, true>(kind, a, s);
  if (dqk != dv) return cudaErrorInvalidValue;
  switch (dqk) {
    case 64: return launch_kind<64, 64, false>(kind, a, s);
    case 128: return launch_kind<128, 128, false>(kind, a, s);
    case 256: return launch_kind<256, 256, false>(kind, a, s);
    case 512: return launch_kind<512, 512, false>(kind, a, s);
  }
  return cudaErrorInvalidValue;
}

// D = rowsum(o∘dO) for contiguous [b, s, h, dh] o and dO into [b, h, s]
// (dh: v's width).
int ko_attention_delta(int dh, const void* o, const void* dout, void* delta,
                       int batch, int heads, int seq, void* stream) {
  const long long rows = (long long)batch * seq * heads;
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* op = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* dp = static_cast<const __nv_bfloat16*>(dout);
  float* out = static_cast<float*>(delta);
  switch (dh) {
    case 64: delta_kernel<64><<<blocks, 256, 0, s>>>(op, dp, out, rows, heads, seq); break;
    case 128: delta_kernel<128><<<blocks, 256, 0, s>>>(op, dp, out, rows, heads, seq); break;
    case 256: delta_kernel<256><<<blocks, 256, 0, s>>>(op, dp, out, rows, heads, seq); break;
    case 512: delta_kernel<512><<<blocks, 256, 0, s>>>(op, dp, out, rows, heads, seq); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Dynamic shared memory bytes a block of `kind` takes at widths (`dqk`,
// `dv`) (-1 for widths the library does not hold).
int ko_attention_smem(int kind, int dqk, int dv) {
  switch (kind) {
    case kFwd: return smem_of<kFwd>(dqk, dv);
    case kDv: return smem_of<kDv>(dqk, dv);
    case kDk: return smem_of<kDk>(dqk, dv);
    case kDq: return smem_of<kDq>(dqk, dv);
  }
  return -1;
}

}  // extern "C"
