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
// where a product with a given softmax scale replaces the division,
// S = bf16(q·kᵀ)·scale and dS = bf16(P∘(dO·vᵀ - D)·scale), each one f32
// multiply as the chain's.
//
// Launches. Forward: one (kind kFwd), writing o and lse: at equal widths
// the lock-step kernel below, at the pair a walk on the pipeline below.
// Backward, with no atomics, so the gradients are the same bits from run to
// run: at equal widths four: D (delta_kernel), then dV and dK (kinds kDv
// and kDk: one block per 64-row K tile, walking the Q tiles from the
// diagonal down) and dQ (kind kDq: one block per 64-row Q tile, walking the
// K tiles up to the diagonal); at the pair three: D, then dK and dV in one
// walk (kind kDkv) and dQ (kind kDq), both on the pipeline.
//
// What bounds it on the H100. Forward is two b·h·s²·dh products over the
// causal half, backward eight at equal widths (S recomputed in each of dV,
// dK and dQ; dP in dK and dQ; then bf16(P)ᵀ·dO, dSᵀ·q and dS·k), seven at
// the pair (S and dP formed once for dK and dV). At dh = 512 a score costs
// 1024 multiply-adds against a few dozen instructions of softmax, so the
// work is the tensor cores'. What holds them back is feeding them: a block
// re-reads every K/V (or Q/dO) tile of its walk from L2, 128 KB a tile for
// 8.4 MFLOP in kFwd and kDv, and the block works in lock step (products,
// then the softmax while the tensor cores idle, then products).
//
// Design at equal widths (the lock-step kernels; the pair's are further
// down). Every kind is one shape: a block holds a 64-row tile (A1, and A2
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
// The pair's kernels (kinds kFwd, kDkv and kDq at (192, 128), `attention_
// kernel_pipelined`): warp-specialised walks fed by TMA. A block is three
// warpgroups. The producer (setmaxnreg 24) loads the held tiles once and
// keeps the streamed tiles coming through a ring of 3 stages (kFwd 4): one
// warp, one lane starting cp.async.bulk.tensor copies of 64-column boxes (4-d
// maps over [b, s, h, width] with the tensors' own strides, 128-byte
// swizzled: the layout above; rows past s read as zeros), its 32 lanes
// writing the streamed Q rows' lse and D beside them (kDkv), each stage
// with a full and an empty mbarrier. Two consumer warpgroups (setmaxnreg
// 240) each own 64 rows of a 128-row held tile and walk the same stages:
// wgmma for the score products (both operands in shared memory; kFwd's
// below), the elementwise chain, wgmma for the accumulation (bf16
// fragments from registers), release. In the backward the two meet only at
// the ring, so one's elementwise work runs while the other's products hold
// the tensor cores (named-barrier turns, tried there, took 6 ms more a
// layer at the Kimi-K2 cell's shape; the forward's are below). A
// warpgroup skips the streamed tiles wholly above the diagonal for its own
// rows. Blocks of one (b, h) run together, so its streamed tiles are read
// from L2; kFwd and kDq start with the longest walks (the last Q tiles).
//   kFwd: held A1 = q; streamed B1 = k, B2 = v (64 rows)
//         S = A1·B1ᵀ, the lock-step kFwd's softmax step; o += bf16(P)·B2;
//         o / l and lse = m + log(l) written once at the end
//   kDkv: held A1 = k, A2 = v; streamed B1 = q, B2 = dO (48 rows)
//         Sᵀ = A1·B1ᵀ, dPᵀ = A2·B2ᵀ; P = exp(Sᵀ·scale - lse), dS as above;
//         dv += bf16(P)ᵀ·B2, dk += dSᵀ·B1; written once at the end
//   kDq:  held A1 = q, A2 = dO; streamed B1 = k, B2 = v (64 rows)
//         S = A1·B1ᵀ, dP = A2·B2ᵀ; dq += dS·B1
// Each (q row, k row) pair costs 640 column-units of products in kDkv (S
// 192, dP 128, dV 128, dK 192) and 512 in kDq: 1152, against 1344 in the
// four-launch form and 640 that kobench/flops_mla.py::k3_operations counts
// for a backward. Registers of a consumer thread: kDkv dk [64, 192] f32 96,
// dv [64, 128] 64, Sᵀ and dPᵀ [64, 48] 24 each: 208 of 240 (at 64 streamed
// rows, 224, ptxas spilled 280 bytes); kDq dq 96, S and dP [64, 64] 32
// each: 160. The producer at 24 frees exactly what the consumers take at
// 240 (the block's 384 × 168 at launch; at 32 the consumers waited
// forever). ptxas (nvcc 12.9): both 168 registers at launch, 0 spilled
// bytes; shared memory 176,312 B (kDkv: 80 KB held, 3 × 30 KB streamed)
// and 207,416 B (kDq: 80 KB, 3 × 40 KB); one block an SM. Each
// accumulator sums its 16-row k-steps in the order the four-launch form
// does, and the gradients came out as its bits at every shape tried.
//
// The pair's forward (kFwd) goes further than the backward's walks. A
// consumer reads its 64 Q rows once from the held tile into registers, as
// the A fragments of the score product (192 columns: 48 registers), so
// wgmma reads only K from shared memory; and it runs one tile ahead: tile
// j's q·kᵀ and tile j - 1's P·v are started together, tile j's softmax runs
// while P·v holds the tensor cores, and a stage is released once its P·v
// is done. The two consumers start their products in turns (named
// barriers 1 and 2, consumer 0 first, only over the starts both make), so
// one's softmax runs under the other's products; the rescale of o is
// skipped where alpha is exactly 1 (a product by 1 is exact). Registers of
// a consumer thread: o [64, 128] f32 64, S [64, 64] 32, P's bf16 fragments
// 16, Q's 48: 160 of 240. ptxas (nvcc 12.9): 168 registers at launch, 0
// spilled bytes; shared memory 214,088 B (48 KB held, 4 × 40 KB
// streamed); one block an SM. The lock-step forward's rounding points, and its k-step order at its 64-row
// streamed tiles, so o and lse are its bits (at every shape tried on the
// card). At 3×8192 tokens and 64 heads, on an H100 SXM at 700 W, it took
// 8.72 ms against the lock-step form's 14.94 (4.17 ms at 989 TFLOP/s).
// Tried there: the lock-step order on the ring 9.19-9.36 ms, one tile
// ahead alone 9.44, Q read from shared memory 9.49, no turns 8.85, o always
// rescaled 8.80; one tile ahead with Q in shared memory at 3 stages 9.60
// and at 2 stages 10.73 (4: 9.47).
// The dense widths keep the lock-step forward: at dh 512 its [64, 512] f32
// accumulator is half the register file, split over two warpgroups that
// trade partial scores, so two consumers that each own 64 rows cannot hold
// it.
//
// Rounding points: the chain's, except one a one-pass kernel cannot keep:
// the chain normalises P before its cast to bf16, the kernel divides the f32
// sum of P·v by the row's sum after it. The division by sqrt(dh) is
// t = x·r, then t + fma(-t, root, x)·r with r the f32 nearest 1/root: the
// correctly rounded quotient for |x| >= 2^-100 (ops/attention.py::divisor).
// exp is ex2.approx of x·log2(e); nothing drops to fp8 or TF32.

#include <cuda.h>
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

enum Kind { kFwd = 0, kDv = 1, kDk = 2, kDq = 3, kDkv = 4 };

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

// d (64 x 48, f32) = (scale ? d : 0) + A·Bᵀ, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t a, uint64_t b,
                                            int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
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

// starts s (this warp's 16 rows of a 64 x kBN score tile over the
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

// ---- the pair's kernels: warp-specialised walks fed by TMA ---------------

// Tiles of kinds kFwd, kDkv and kDq at the pair (see the header): a held
// tile of 128 rows, 64 for each consumer warpgroup (A1 alone for kFwd);
// streamed tiles of kBn rows (48 where dK and dV both sit in registers) in
// a ring of kStages, each with its lse and D rows (kDkv; kDq keeps the
// room).
template <int KIND, int DQK, int DV>
struct Pipe {
  static constexpr bool kFwdWalk = KIND == kFwd;
  static constexpr int kHeldRows = 128;
  static constexpr int kBn = KIND == kDkv ? 48 : 64;
  static constexpr int kStages = kFwdWalk ? 4 : 3;
  static constexpr int kThreads = 384;   // producer, two consumers
  static constexpr int kA1 = kHeldRows * DQK * 2;
  static constexpr int kA2 = kFwdWalk ? 0 : kHeldRows * DV * 2;
  static constexpr int kB1 = kBn * DQK * 2, kB2 = kBn * DV * 2;
  static constexpr int kStage = kB1 + kB2;
  static constexpr int kTiles = kA1 + kA2 + kStages * kStage;
  static constexpr int kStats = kFwdWalk ? 0 : 2 * kBn * 4;
  // barriers: the held tiles', then full and empty of each stage
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  // + 1 KB to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmem = kTiles + kStages * kStats + kBars + 1024;
  static_assert(kSmem <= kMaxSmem, "tiles exceed shared memory");
  static_assert(kBn % 16 == 0 && (kBn * 128) % 1024 == 0,
                "streamed tiles are whole 8-row swizzle periods");
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "tiles are blocks of 64 columns");
};

// What the pair's pipelined kernels read: the tiles' TMA maps (held A1, A2
// (not kFwd); streamed B1, B2), the outputs and the row statistics.
struct TmaArgs {
  CUtensorMap held1, held2, stream1, stream2;
  __nv_bfloat16* out1;   // dk (kDkv) or dq: [b, s, h, DQK]; o (kFwd): [b, s, h, DV]; contiguous
  __nv_bfloat16* out2;   // dv (kDkv): [b, s, h, DV] contiguous
  const float* lse;      // [b, h, s] (backward)
  const float* delta;    // [b, h, s] (backward)
  int bh, heads, seq;
  float scale;
  float* lse_out;        // [b, h, s] (kFwd)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// an arrival that also expects `bytes` of copies to complete the phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// box (64 columns from `col`, `rows` rows from `row`) of head `head` of
// batch entry `batch` into `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int head, int row,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head),
         "r"(row), "r"(batch), "r"(bar) : "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale) {
  static_assert(BN == 64 || BN == 48, "streamed tiles of 64 or 48 rows");
  if constexpr (BN == 64) wgmma_ss_n64(d, a, b, scale);
  else wgmma_ss_n48(d, a, b, scale);
}

// starts s (this warp's 16 rows of 64 x BN) = a 64-row slice `a` of a held
// tile whose 64-column blocks lie ABLOCK bytes apart, times the BN rows of
// `b`, over KC columns; both operands K-major
template <int KC, int BN, int ABLOCK>
__device__ __forceinline__ void start_scores(float s[BN / 8][4], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    const int k = kk * 16;
    const uint32_t in = (k & 63) * 2;
    wgmma_ss<BN>(&s[0][0], smem_desc(a + (k >> 6) * ABLOCK + in, 16, 1024),
                 smem_desc(b + (k >> 6) * (BN * 128) + in, 16, 1024), kk);
  }
}

// starts acc (16 rows by KC columns) += p (16 x BN, bf16 fragments) times
// the BN rows of `c` (MN-major); 192 columns as 128 + 64
template <int KC, int BN>
__device__ __forceinline__ void start_accumulate(float acc[KC / 8][4],
                                                 uint32_t p[BN / 16][4],
                                                 uint32_t c) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t at = c + kk * 16 * 128;
    if constexpr (KC == 192) {
      wgmma_rs<128>(&acc[0][0], p[kk], smem_desc(at, BN * 128, 1024));
      wgmma_rs<64>(&acc[16][0], p[kk],
                   smem_desc(at + 2 * (BN * 128), BN * 128, 1024));
    } else {
      wgmma_rs<KC>(&acc[0][0], p[kk], smem_desc(at, BN * 128, 1024));
    }
  }
}

// the accumulator's 16 rows of this warp, bf16, to rows of a contiguous
// [b, s, h, KC] output
template <int KC>
__device__ __forceinline__ void store_rows(float acc[KC / 8][4],
                                           __nv_bfloat16* out, const int row[2],
                                           int b, int h, int heads, int seq,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= seq) continue;
    __nv_bfloat16* dst =
        out + ((long long)b * seq + row[i]) * heads * KC + h * KC + 2 * t;
#pragma unroll
    for (int n = 0; n < KC / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// waits until at most N committed groups of this warpgroup's wgmma are
// still running
template <int N>
__device__ __forceinline__ void wg_wait_for() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers that an asynchronous wgmma reads or writes, pinned at this
// point: no use or new value of them is moved across it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The forward's softmax step on this warp's 16 rows of a BN-column score
// tile from column s0: S scaled and masked (where the diagonal crosses the
// tile), the rows' running max m and sum l moved on, s turned into
// p = exp(S - m) in place; alpha = exp(m before - m after) rescales what
// the rows summed before. The lock-step kFwd's arithmetic, step for step.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 8][4],
                                               float m_i[2], float l_i[2],
                                               float alpha[2], int s0,
                                               const int row[2], bool diag,
                                               float scale, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(bf16_round(s[jn][e]), scale);
      if (diag && s0 + jn * 8 + 2 * t + (e & 1) > row[e >> 1]) x = kMask;
      s[jn][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(m_i[i], mx[i]);
    alpha[i] = fexp(m_i[i] - mx[i]);
    m_i[i] = mx[i];
  }
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn)
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
}

// d (64 x 64, f32) = (scale ? d : 0) + A·Bᵀ, A in registers (bf16
// fragments), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_kn64(float* d, const uint32_t* a,
                                             uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// this warp's 16 rows of a 64-row slice `a` of the held tile (128-byte
// swizzled blocks of 64 columns, ABLOCK bytes apart) as the bf16 A
// fragments of a score product over KC columns
template <int KC, int ABLOCK>
__device__ __forceinline__ void held_fragments(uint32_t (&f)[KC / 16][4],
                                               uint32_t a, int wr, int g,
                                               int t) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kk * 16 + (e >> 1) * 8 + 2 * t, r = wr * 16 + g + (e & 1) * 8;
      const uint32_t at = a + (c >> 6) * ABLOCK + r * 128 +
                          ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(f[kk][e]) : "r"(at));
    }
}

// starts s (this warp's 16 rows of 64 x BN) = the A fragments `f` times the
// BN rows of `b`, over KC columns; b K-major
template <int KC, int BN>
__device__ __forceinline__ void start_scores_rs(float (&s)[BN / 8][4],
                                                const uint32_t (&f)[KC / 16][4],
                                                uint32_t b) {
  static_assert(BN == 64, "64-row streamed tiles");
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    const int k = kk * 16;
    wgmma_rs_kn64(&s[0][0], f[kk],
                  smem_desc(b + (k >> 6) * (BN * 128) + (k & 63) * 2, 16, 1024),
                  kk);
  }
}

// the two consumers' turns at the tensor cores: consumer c waits on
// barrier 1 + c and passes to the other's
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// kFwd's consumer warpgroup `cw`: o and lse of its 64 held Q rows (from
// hr0; `q_rows` their slice of the held tile, read once into registers as
// the score product's A fragments), walking the ring's K/V tiles up to the
// one that holds its last row (none where the rows lie past s). One tile
// ahead: tile j's q·kᵀ and tile j - 1's P·v are started together, and tile
// j's softmax runs while P·v still holds the tensor cores; a stage is
// released once its P·v is done. The starts that both consumers make go in
// turns (named barriers 1 and 2, consumer 0 first), so one's softmax runs
// under the other's products.
template <int DQK, int DV, int BN, int STAGES>
__device__ __forceinline__ void forward_rows(const TmaArgs& a, uint32_t q_rows,
                                             uint32_t ring, uint32_t held_bar,
                                             uint32_t full0, uint32_t empty0,
                                             int n_tiles, int cw, int hr0,
                                             const int row[2], int bh, int b,
                                             int h, int wr, int lane) {
  constexpr int kHeldBlock = 128 * 128;     // between the held tile's 64-column blocks
  constexpr int kStage = BN * (DQK + DV) * 2;
  constexpr int kB1 = BN * DQK * 2;          // V after K in a stage
  const int seq = a.seq, g = lane >> 2, t = lane & 3;
  auto tiles_of = [&](int r) { return r < seq ? min(n_tiles, (r + 63) / BN + 1) : 0; };
  const int mine = tiles_of(hr0);
  // starts: 0 (tile 0's S), j (tile j's S and tile j - 1's P·v), mine (the
  // last P·v); the first `turns`, which both consumers make, in turns
  const int both = min(tiles_of(hr0 - 64 * cw), tiles_of(hr0 - 64 * cw + 64));
  const int turns = both > 0 ? both + 1 : 0;
  auto take = [&](int k) {
    if (k < turns) turn_wait(1 + cw);
  };
  auto pass = [&](int k) {
    if (k < turns && !(cw == 1 && k == turns - 1)) turn_pass(2 - cw);
  };
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float sc[BN / 8][4];
  uint32_t pf[BN / 16][4], qf[DQK / 16][4];
  float alpha[2];

  mbar_wait(held_bar, 0);
  held_fragments<DQK, kHeldBlock>(qf, q_rows, wr, g, t);
  if (cw == 1 && turns > 0) turn_pass(1);   // consumer 0 goes first
  if (mine > 0) {                            // tile 0: S, its softmax
    mbar_wait(full0, 0);
    take(0);
    wg_fence();
    start_scores_rs<DQK, BN>(sc, qf, ring);
    wg_commit();
    pass(0);
    wg_wait_for<0>();
    pin(sc);
    online_softmax<BN>(sc, m_i, l_i, alpha, 0, row, BN > hr0, a.scale, t);
    to_fragments<BN>(sc, pf);                // acc is 0: nothing to rescale
  }
  for (int j = 1; j < mine; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    take(j);
    wg_fence();
    start_scores_rs<DQK, BN>(sc, qf, ring + s * kStage);
    wg_commit();
    start_accumulate<DV, BN>(acc, pf, ring + sp * kStage + kB1);
    wg_commit();
    pass(j);
    wg_wait_for<1>();                        // S of tile j
    pin(sc);
    online_softmax<BN>(sc, m_i, l_i, alpha, j * BN, row, (j + 1) * BN > hr0,
                       a.scale, t);
    wg_wait_for<0>();                        // o += p·v of tile j - 1
    pin(acc);
    pin(pf);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * sp);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // times 1 is exact: skipped
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }
    to_fragments<BN>(sc, pf);
  }
  if (mine > 0) {                            // the last tile's P·v
    const int sp = (mine - 1) % STAGES;
    take(mine);
    wg_fence();
    start_accumulate<DV, BN>(acc, pf, ring + sp * kStage + kB1);
    wg_commit();
    pass(mine);
    wg_wait_for<0>();
    pin(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * sp);
  }
  for (int j = mine; j < n_tiles; ++j) {     // the block's tiles past these rows
    const int s = j % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] / l_i[e >> 1];
  store_rows<DV>(acc, a.out1, row, b, h, a.heads, seq, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (t == 0 && row[i] < seq)
      a.lse_out[(long long)bh * seq + row[i]] = m_i[i] + logf(l_i[i]);
}

// kFwd: o and lse of 128 Q rows, walking the K/V tiles up to the diagonal;
// kDkv: dK and dV of 128 K/V rows, walking the Q/dO tiles from the
// diagonal down; kDq: dQ of 128 Q rows, walking the K/V tiles up to the
// diagonal. Warpgroup 0 is the producer (one warp starts the TMA copies and
// reads the lse and D rows of each streamed tile), warpgroups 1 and 2
// consume, each owning 64 held rows; they meet only at the ring's barriers.
template <int KIND, int DQK, int DV>
__global__ void __launch_bounds__(Pipe<KIND, DQK, DV>::kThreads, 1)
    attention_kernel_pipelined(const __grid_constant__ TmaArgs a) {
  using P = Pipe<KIND, DQK, DV>;
  constexpr int kBN = P::kBn;
  constexpr bool kHoldsQ = KIND == kDq || KIND == kFwd;
  constexpr int kHeldBlock = P::kHeldRows * 128;   // between 64-column blocks
  extern __shared__ __align__(128) uint8_t raw[];
  const uint32_t raw_at = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t base = (raw_at + 1023) & ~1023u;
  uint8_t* smem = raw + (base - raw_at);
  const uint32_t held1 = base, held2 = base + P::kA1;
  const uint32_t ring = held2 + P::kA2;   // stage s: B1, then B2
  float* stats = reinterpret_cast<float*>(smem + P::kTiles);   // stage s: lse, D
  const uint32_t held_bar = base + P::kTiles + P::kStages * P::kStats;
  const uint32_t full0 = held_bar + 8, empty0 = full0 + 8 * P::kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.z * 65535 + blockIdx.y;
  if (bh >= a.bh) return;
  const int b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  // the held tile's first row; kFwd and kDq start with the longest walks
  const int r0 = (kHoldsQ ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * P::kHeldRows;
  const int first = kHoldsQ ? 0 : r0;
  const int last = kHoldsQ ? min(r0 + P::kHeldRows, seq) : seq;
  const int n_tiles = (last - first + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(held_bar, 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);    // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 8);    // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect(held_bar, P::kA1 + P::kA2);
#pragma unroll
      for (int c = 0; c < DQK / 64; ++c)
        tma_load(held1 + c * kHeldBlock, &a.held1, c * 64, h, r0, b, held_bar);
      if constexpr (KIND != kFwd) {
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(held2 + c * kHeldBlock, &a.held2, c * 64, h, r0, b, held_bar);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % P::kStages;
      const int s0 = first + j * kBN;
      mbar_wait(empty0 + 8 * s, ((j / P::kStages) & 1) ^ 1);
      if (!kHoldsQ) {   // the streamed Q rows' lse and D
        float* st = stats + s * 2 * kBN;
        for (int i = lane; i < kBN; i += 32) {
          const int m = s0 + i;
          const long long at = (long long)bh * seq + m;
          st[i] = m < seq ? a.lse[at] : INFINITY;
          st[kBN + i] = m < seq ? a.delta[at] : 0.f;
        }
      }
      if (lane == 0) {
        const uint32_t full = full0 + 8 * s;
        const uint32_t b1 = ring + s * P::kStage, b2 = b1 + P::kB1;
        mbar_expect(full, P::kStage);
#pragma unroll
        for (int c = 0; c < DQK / 64; ++c)
          tma_load(b1 + c * (kBN * 128), &a.stream1, c * 64, h, s0, b, full);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(b2 + c * (kBN * 128), &a.stream2, c * 64, h, s0, b, full);
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = (warp >> 2) - 1;   // consumer warpgroup 0 or 1
  const int wr = warp & 3, g = lane >> 2, t = lane & 3;
  const int hr0 = r0 + 64 * cw;     // its held rows
  const int row[2] = {hr0 + wr * 16 + g, hr0 + wr * 16 + g + 8};
  if constexpr (KIND == kFwd) {
    forward_rows<DQK, DV, kBN, P::kStages>(a, held1 + cw * 64 * 128, ring,
                                            held_bar, full0, empty0, n_tiles,
                                            cw, hr0, row, bh, b, h, wr, lane);
  } else {
    const uint32_t a1 = held1 + cw * 64 * 128, a2 = held2 + cw * 64 * 128;
    float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};   // kDq: the held rows'
    if (kHoldsQ) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long at = (long long)bh * seq + row[i];
        lse_r[i] = row[i] < seq ? a.lse[at] : INFINITY;
        d_r[i] = row[i] < seq ? a.delta[at] : 0.f;
      }
    }
    float acc1[DQK / 8][4];                          // dk or dq
    float acc2[KIND == kDkv ? DV / 8 : 1][4];        // dv
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < (KIND == kDkv ? DV / 8 : 1); ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;

    mbar_wait(held_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % P::kStages;
      const int s0 = first + j * kBN;   // first row of the streamed tile
      const uint32_t b1 = ring + s * P::kStage, b2 = b1 + P::kB1;
      // some pair of this tile is on or below the diagonal for these rows;
      // the diagonal crosses it
      const bool live = kHoldsQ ? s0 <= hr0 + 63 : s0 + kBN - 1 >= hr0;
      const bool diag = kHoldsQ ? s0 + kBN > hr0 : s0 < hr0 + 64;
      mbar_wait(full0 + 8 * s, (j / P::kStages) & 1);

      float sc[kBN / 8][4] = {}, dp[kBN / 8][4] = {};
      if (live) {
        wg_fence();
        start_scores<DQK, kBN, kHeldBlock>(sc, a1, b1);
        start_scores<DV, kBN, kHeldBlock>(dp, a2, b2);
        wg_commit();
        wg_wait();
        const float* st = stats + s * 2 * kBN;
#pragma unroll
        for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = jn * 8 + 2 * t + (e & 1);
            const int r = row[e >> 1];
            float x = __fmul_rn(bf16_round(sc[jn][e]), a.scale);
            if (diag && (kHoldsQ ? s0 + col > r : s0 + col < r)) x = kMask;
            const float lse = kHoldsQ ? lse_r[e >> 1] : st[col];
            const float d = kHoldsQ ? d_r[e >> 1] : st[kBN + col];
            const float p = fexp(x - lse);
            dp[jn][e] = __fmul_rn(p * (dp[jn][e] - d), a.scale);
            sc[jn][e] = p;
          }
        uint32_t df[kBN / 16][4], pf[kBN / 16][4];
        to_fragments<kBN>(dp, df);
        if constexpr (KIND == kDkv) {
          to_fragments<kBN>(sc, pf);
          wg_fence();
          start_accumulate<DV, kBN>(acc2, pf, b2);    // dv += bf16(P)ᵀ·dO
          start_accumulate<DQK, kBN>(acc1, df, b1);   // dk += dSᵀ·q
        } else {
          wg_fence();
          start_accumulate<DQK, kBN>(acc1, df, b1);   // dq += dS·k
        }
        wg_commit();
        wg_wait();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    store_rows<DQK>(acc1, a.out1, row, b, h, a.heads, seq, t);
    if constexpr (KIND == kDkv)
      store_rows<DV>(acc2, a.out2, row, b, h, a.heads, seq, t);
  }
}

// CUresult cuTensorMapEncodeTiled(...), fetched from the driver at run time
// so the library links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 [batch, seq, heads, cols] tensor (head columns contiguous; strides
// in elements) read as boxes of 64 columns by `rows` rows of one head,
// 128-byte swizzled (the layout of `swz`); rows past seq read as zeros
bool tensor_map(CUtensorMap* m, const void* p, int cols, int heads, int seq,
                int batch, long long sh, long long ss, long long sb, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// One launch of the pair's pipelined kernels (kind kFwd: o to a.out, lse
// to a.lse_out; kind kDkv: dk to a.out, dv to `out2`; kind kDq: dq to
// a.out).
template <int KIND, int DQK, int DV>
int launch_pipelined(const PairArgs& a, void* out2, cudaStream_t stream) {
  using P = Pipe<KIND, DQK, DV>;
  const int batch = a.bh / a.heads;
  // dO: contiguous [b, s, h, DV]
  const long long doh = DV, dos = (long long)a.heads * DV, dob = dos * a.seq;
  TmaArgs t{};
  const bool ok =
      KIND == kFwd
          ? tensor_map(&t.held1, a.q, DQK, a.heads, a.seq, batch, a.sqh, a.sqs, a.sqb, P::kHeldRows) &&
            tensor_map(&t.stream1, a.k, DQK, a.heads, a.seq, batch, a.skh, a.sks, a.skb, P::kBn) &&
            tensor_map(&t.stream2, a.v, DV, a.heads, a.seq, batch, a.svh, a.svs, a.svb, P::kBn)
      : KIND == kDq
          ? tensor_map(&t.held1, a.q, DQK, a.heads, a.seq, batch, a.sqh, a.sqs, a.sqb, P::kHeldRows) &&
            tensor_map(&t.held2, a.dout, DV, a.heads, a.seq, batch, doh, dos, dob, P::kHeldRows) &&
            tensor_map(&t.stream1, a.k, DQK, a.heads, a.seq, batch, a.skh, a.sks, a.skb, P::kBn) &&
            tensor_map(&t.stream2, a.v, DV, a.heads, a.seq, batch, a.svh, a.svs, a.svb, P::kBn)
          : tensor_map(&t.held1, a.k, DQK, a.heads, a.seq, batch, a.skh, a.sks, a.skb, P::kHeldRows) &&
            tensor_map(&t.held2, a.v, DV, a.heads, a.seq, batch, a.svh, a.svs, a.svb, P::kHeldRows) &&
            tensor_map(&t.stream1, a.q, DQK, a.heads, a.seq, batch, a.sqh, a.sqs, a.sqb, P::kBn) &&
            tensor_map(&t.stream2, a.dout, DV, a.heads, a.seq, batch, doh, dos, dob, P::kBn);
  if (!ok) return cudaErrorInvalidValue;
  t.out1 = a.out;
  t.out2 = static_cast<__nv_bfloat16*>(out2);
  t.lse = a.lse;
  t.delta = a.delta;
  t.bh = a.bh;
  t.heads = a.heads;
  t.seq = a.seq;
  t.scale = a.rinv;
  t.lse_out = a.lse_out;
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel_pipelined<KIND, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.seq + P::kHeldRows - 1) / P::kHeldRows,
            a.bh < 65535 ? a.bh : 65535, (a.bh + 65534) / 65535);
  attention_kernel_pipelined<KIND, DQK, DV><<<grid, P::kThreads, P::kSmem, stream>>>(t);
  return cudaGetLastError();
}

// Equal widths: the four lock-step kinds. The pair: the forward and the
// backward's kinds kDkv and kDq, each on the pipeline.
template <int DQK, int DV, bool SCALE>
int launch_kind(int kind, const PairArgs& a, void* out2, cudaStream_t stream) {
  if constexpr (DQK != DV) {
    switch (kind) {
      case kFwd: return launch_pipelined<kFwd, DQK, DV>(a, out2, stream);
      case kDkv: return launch_pipelined<kDkv, DQK, DV>(a, out2, stream);
      case kDq: return launch_pipelined<kDq, DQK, DV>(a, out2, stream);
    }
  } else {
    switch (kind) {
      case kFwd: return launch<kFwd, DQK, DV, SCALE>(a, stream);
      case kDv: return launch<kDv, DQK, DV, SCALE>(a, stream);
      case kDk: return launch<kDk, DQK, DV, SCALE>(a, stream);
      case kDq: return launch<kDq, DQK, DV, SCALE>(a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <int KIND>
int smem_of(int dqk, int dv) {
  if (dqk == 192 && dv == 128) {
    if constexpr (KIND == kFwd || KIND == kDkv || KIND == kDq) return Pipe<KIND, 192, 128>::kSmem;
    else return -1;
  }
  if constexpr (KIND == kDkv) return -1;
  else {
    if (dqk != dv) return -1;
    switch (dqk) {
      case 64: return Plan<KIND, 64, 64>::kSmem;
      case 128: return Plan<KIND, 128, 128>::kSmem;
      case 256: return Plan<KIND, 256, 256>::kSmem;
      case 512: return Plan<KIND, 512, 512>::kSmem;
    }
    return -1;
  }
}

}  // namespace

extern "C" {

// One launch of kind `kind` at head widths `dqk` = `dv` (64, 128, 256 or
// 512; S divided by `root`; kinds 0 forward, 1 dV, 2 dK, 3 dQ) or (`dqk`,
// `dv`) = (192, 128) (S times the scale `rinv`; kinds 0 forward, 4 dK and
// dV, dk to `out` and dv to `out2`, 3 dQ). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a kind or widths the library does not hold.
int ko_attention(int kind, int dqk, int dv, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, void* out, void* out2, void* lse_out,
                 long long sqb, long long sqs, long long sqh, long long skb,
                 long long sks, long long skh, long long svb, long long svs,
                 long long svh, int batch, int heads, int seq, float root,
                 float rinv, void* stream) {
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
  if (dqk == 192 && dv == 128) return launch_kind<192, 128, true>(kind, a, out2, s);
  if (dqk != dv) return cudaErrorInvalidValue;
  switch (dqk) {
    case 64: return launch_kind<64, 64, false>(kind, a, out2, s);
    case 128: return launch_kind<128, 128, false>(kind, a, out2, s);
    case 256: return launch_kind<256, 256, false>(kind, a, out2, s);
    case 512: return launch_kind<512, 512, false>(kind, a, out2, s);
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
    case kDkv: return smem_of<kDkv>(dqk, dv);
  }
  return -1;
}

}  // extern "C"
