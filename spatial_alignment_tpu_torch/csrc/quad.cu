// Diagonal quadratic forms of the SVGP predictive variance, for Hopper:
//
//   out[g, b, n] = sum_k t[g, b, n, k]^2,   t[g, b, n, :] = x[g, n, :] @ F_b
//
// with x (G, N, m) and the channel factors F either shared, (L, m, m), or
// one set per group, (G, L, m, m); and the backward pass
//
//   w = 2 dy t,   dx[g, n, :] = sum_b w[g, b, n, :] @ F_b^T,
//   dF_b = sum over the rows that use F_b of x[g, n, :]^T w[g, b, n, :].
//
// Replaces the TPU kernels spatial_alignment_tpu/ops/pallas_quad.py
// _fwd_pallas (body _fwd_body) and _bwd_pallas (body _bwd_body). What they
// are for carries over: the (G, L, N, m) product t is never written to
// device memory (162 MB at the data layer of the m = 200 fit: S = 5
// samples of N = 4,050 points, L = 10 channels); each tile of it is made in
// registers, used and dropped, and the backward makes it again. The TPU layout (k-major Fcat,
// selector dots, one VMEM-resident dF carried across grid steps) does not.
//
// The forward, quad_fwd_kernel (replaces _fwd_pallas / _fwd_body). What
// bounds it: operations, 2 G N L m^2 of them (1.6e10 at the data layer of
// the m = 200 fit, 0.24 ms at the 67 TFLOP/s of the plain fp32 pipes); it
// reads 16 MB of x and writes 1.6 MB. So t runs on the tensor cores, in
// 3xTF32: each fp32 operand is split into a TF32 high part (hi, its top 10
// mantissa bits) and the rest (lo = a - hi, exact in fp32, read by the
// tensor core as TF32), and mma.sync m16n8k8 accumulates lo*hi + hi*lo +
// hi*hi in fp32 (the JAX kernel's 3-pass split product, pallas_quad.py:
// 116-143, with TF32 for bf16). That is 3x the products, 0.10 ms at the
// 495 TFLOP/s TF32 peak, and keeps t within about 2^-21 of a product (lo*lo
// is dropped); a single TF32 pass would lose about 3 digits. The split is
// made here, whatever PyTorch's TF32 flags.
//   Tiles: a block of warps makes a BM-point x BN-column tile of t for one
// channel, each warp MT x NT mma tiles: 128 x 128 (8 warps of 64 x 32, two
// blocks an SM) when that gives two waves of blocks, as at the data layer;
// 64 x 128 (8 warps of 32 x 32) above m = 64 otherwise, as at the warp
// layer; 64 x 64 (4 warps of 32 x 32) up to m = 64. The depth goes in
// stages of 32 brought in by cp.async (16 bytes when m is a multiple of 4
// and x and F are aligned, else 4), three stages in flight, one barrier a
// stage; the ragged edge is zero-filled by the copy. x rows are padded to
// 36 floats and F rows to BN + 8 in shared memory, so every fragment load
// of a warp hits 32 banks. The mma go pass by pass (every tile's lo hi,
// then hi lo, then hi hi), the next step's fragments read before they
// issue; depth steps of 8 and column tiles of 8 wholly past m are skipped,
// in a second copy of the stage body so that the full one has no condition
// around an mma (a predicated mma.sync costs a warp re-convergence each).
//   Epilogue: square the accumulators and sum each row over the thread's
// columns, across the 4 lanes that share the row (shuffles) and across the
// warps that share it (shared memory), in a fixed order.
//   The columns of t are split across a thread-block cluster of
// nk = min(8, ceil(m / BN)) blocks (2 at m = 200 with BN = 128), block r
// taking column tiles r, r + nk, ...: the warp layer's 32 point tiles x 2
// channels make 128 blocks instead of 64. Each block stores its row sums
// into the leader's shared memory (distributed shared memory); after one
// cluster barrier the leader adds the nk of them in rank order and stores
// each output once. No atomics: two launches on the same input are
// bit-equal.
//
// The backward, quad_bwd_tc_kernel (replaces _bwd_pallas / _bwd_body).
// What bounds it: operations. t is a product of the forward's size, and dx
// and dF are two more: 3 x 2 G N L m^2 (4.9e10 at the data layer, 0.73 ms on
// the fp32 pipes); in 3xTF32 on the tensor cores, 0.30 ms at the TF32 peak
// (at m = 384: 1.8e11, 1.09 ms).
// Both outputs take the same shape of work, two chained products a chunk,
// as attention does (S = Q K^T, P = f(S), O += P V):
//
//   dx  (rows: 16 points a warp)   S = x F_b[:, c]     w = 2 dy[n] S   dx += w F_b[:, c]^T
//   dF^T (rows: 16 columns k of F_b a warp)
//                                  S^T = F_b[:, k]^T x[c, :]^T
//                                  w^T = 2 dy[c] S^T   dF_b^T += w^T x[c, :]
//
// A block of 8 warps keeps its R rows' operand resident in shared memory
// (x's rows for dx, an R-column slab of F_b for dF) and streams chunks of 32
// (columns k of one channel's F_b for dx; points for dF), three buffers deep
// by cp.async (two where three do not fit, m > 200), one barrier a chunk;
// 16-byte copies when m is a multiple of 4. Up to m = 256, R = 128 and each
// warp owns 16 rows: per chunk it makes its 16 x 32 tile of t in registers
// (3xTF32 mma.sync m16n8k8, as the forward), scales it by 2 dy in the
// epilogue, splits it once into TF32 high and low parts, and feeds it, still
// in registers, as the A operand of the second product into a 16 x m
// accumulator (m / 2 registers a lane, 128 at m = 256). The
// accumulator layout of an mma tile holds columns 2 tig and 2 tig + 1 where
// an A fragment wants tig and tig + 4; the second product sums over those
// columns, so it takes them in that order and reads its B operand (the same
// chunk, transposed) as pairs of neighbours, one 8-byte load. Row strides of
// x tiles = 4 mod 8 floats and of F tiles = 8 mod 16 keep every fragment load
// on 32 banks. Edges are zero-filled by the copies (exact), so any m up to
// 256 runs one code path; columns past m are computed and never stored, and
// a chunk's column tiles past m (or past the points) are skipped in a second
// copy of the chunk body, so that a full chunk has no condition around an
// mma. Tried and dropped: 16 warps, each pair of warps splitting a row
// group's accumulator and sharing w through shared memory (slower, and
// spilling at m = 200); two accumulators for t's high and cross terms, and
// fragments read a step ahead (slower: ptxas already schedules the unrolled
// body).
//   Above m = 256 a warp's accumulator would take more than 128 registers
// (192 at m = 384), and 128 resident rows of x (199 KB at m = 384) or a
// 128-column F slab (209 KB) leave no room for a chunk. So R = 64: two warps
// share each group of 16 rows, each keeping half of the accumulator's
// columns (96 registers at m = 384) and making half of each chunk's tiles of
// t (16 of its 32 columns). They swap w = 2 dy t through shared memory, lane
// to lane in fragment order (8 KB a block), behind one named barrier of the
// pair a chunk (bar.sync 1 + row group, 64 threads), so t is still made
// twice, once a pass. At m = 384 the x tile takes 99 KB and two F chunks
// 123 KB (dx); the F slab 111 KB and two x chunks 100 KB (dF). Up to
// m = 512 the same design runs with one chunk buffer (no copy in flight
// while a chunk is used: two barriers a chunk). With two tiles of t a warp,
// each tile's first product runs as two chains, the even and the odd depth
// steps of 8, added at the end (1-2 % faster at m = 384 than one chain).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, tools/
// kernel_probe.py): 4.19 ms at the m = 384 data layer, x (5, 4050, 384),
// F (10, 384, 384), against the first design's 36.3 and the plain
// version's 4.83. Issuing 8 second-product tiles together instead of 4
// made no difference; unrolling the depth loop 2 times instead of 4 was 6 %
// slower.
//   The sums over chunks run in a fixed order inside a block. To fill the
// card, the chunks (channel, column block) of dx and the points of dF are
// split over `splits` blocks, each writing its partial sum, and
// quad_sum_kernel adds the partial sums in split order. The split counts
// are chosen on the host from the occupancy the kernels get (fewest waves a
// chunk of work). No atomics: two launches on the same input are bit-equal.
// Making t once for both outputs would need a reduction of dx over channels
// and column blocks and of dF over points in one pass: partial sums of dx
// for every (channel, column block), 1.1 GB at the data layer, or float
// atomics. So t is made twice, 4 products instead of 3.
//
// Precision. The TPU kernels take the library's precision names
// (pallas_quad.py:_dot_prec, 116-143): "highest" f32, "high" a 3-pass bf16
// split, "default" one bf16 pass. This file is built twice, and the wrapper
// (ops/quad.py) picks the build by name:
//   libquad       (SAT_QUAD_TF32_PASSES 3) for "high" and "highest": every
//                 product in 3xTF32 as above, within about 2^-21 of a
//                 product, better than the TPU's bf16_3x (about 2^-16);
//   libquad_tf32  (SAT_QUAD_TF32_PASSES 1) for "default": each operand
//                 rounded to TF32 once (cvt.rna, 10 mantissa bits: within
//                 2^-11 of it), one mma.sync a tile where 3xTF32 issues
//                 three, so each product is within about 2^-10 of the exact
//                 one and the sums are fp32 (cuBLAS's TF32 mode, JAX's GPU
//                 meaning of DEFAULT; the TPU's one bf16 pass keeps 7 bits).
//                 In the backward, t and w = 2 dy t are made in fp32 and
//                 rounded the same way as the second product's operand.
// Where the one-pass build runs the designs above (m not a multiple of 4,
// or m > 256) their tiles, cluster split and order of every sum are the
// 3xTF32 build's; only the mma passes differ.
//
// The one-pass build at m <= 256 with m a multiple of 4: warpgroup MMA.
// mma.sync reaches about a sixth of the card's TF32 rate; only wgmma, an
// asynchronous product of a 64-row tile by a warpgroup with B (and here
// mostly A) read from shared memory, reaches all of it. The kernels
// quad_fwd_kernel_wgmma and quad_bwd_tc_kernel_wgmma (the dx and dF passes)
// keep the algorithm above: 128 resident rows a block (x's points for the
// forward and dx, F_b^T's columns for dF), chunks streamed, two chained
// products a chunk with t made in the accumulator, scaled by 2 dy, rounded
// and fed from its own registers as the A operand of the second product;
// dx and dF two passes; partial sums of the splits added in split order by
// quad_sum_kernel (launches bit-equal). What changes (design note above
// quad_fwd_kernel_wgmma):
//   - Blocks of two warpgroups (256 threads, so 255 registers a thread),
//     each on 64 resident rows: at m = 200 a warpgroup holds t (100
//     registers) beside its accumulator (100), so a dx chunk is a whole
//     channel. (A producer warpgroup with setmaxnreg left ptxas at the 168
//     registers of a 384-thread block, and it serialized the products.)
//   - Operands K-major (wgmma takes 32-bit operands no other way), in
//     32-deep slices of 128-byte rows with the 128-byte swizzle, rounded to
//     TF32 first (wgmma itself truncates): quad_prep_kernel writes F_b^T
//     (rows in the order sigma below), F_b and, for the backward, x and x^T,
//     rounded and already in that layout, so that each slot of the ring is
//     one bulk copy (cp.async.bulk, the TMA engine, 1-D, under an
//     mbarrier). The backward's copies replace the contiguous copy of x the
//     mma.sync designs take; its transient memory falls (fewer dF splits).
//     The forward makes no copy of x: its resident x tile goes through
//     registers, rounded on the way.
//   - The accumulator holds columns 2 tig, 2 tig + 1 where the A fragment
//     wants depth tig, tig + 4: the first product's B rows (F_b^T's columns,
//     or x's points for dF) are in the order sigma = (0 4 1 5 2 6 3 7) within
//     each 8, so the second product's B stays in index order.
//   - A ring of 4 slots (3 at m = 256) runs 4 slices ahead; the last warp to
//     release a slot refills it at once (a count in shared memory).
// What bounds them: the same operations (one TF32 pass, 495 TFLOP/s):
// 0.0327 ms forward and 0.0982 ms backward at the data layer of the m = 200
// fit (x (5, 4050, 200), F (10, 200, 200)). Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md), x transposed as the model passes it, the
// wrapper's launches together: forward 0.0981 ms (the mma.sync one-pass
// design 0.2472), backward 0.4217 (0.8386); at the warp layer, x (1, 2025,
// 200), F (1, 2, 200, 200), 0.0168 (0.0117: 32 blocks) and 0.0454 (0.0538).
// In a dx block the first product (its A, the resident tile, read from
// shared memory; 200 columns) takes about 63 % of the time for half the
// operations, and waits for slices about 24 %; the dF pass computes 56
// padding rows of its last row tile at m = 200.
//
// Above m = 512 the accumulator and the resident tile outgrow a block, and
// the first design runs (the wide variant, off every path the repo runs,
// in fp32 tiles in both builds):
// 64 x 64 tiles of t on the plain fp32 pipes, 256 threads with a 4 x 4
// register tile each, x and F staged 16 deep,
//   quad_dx_kernel    grid (N/64, G): dx for the block's points over 256
//                     columns a pass, looping over channels and k-tiles;
//   quad_df_kernel    grid (m/64, L, splits x factor groups): a 256 x 64
//                     block of dF_b over one range of rows (partial sums);
//   quad_sum_kernel   adds the partial sums in a fixed order.

#include <cooperative_groups.h>
#include <algorithm>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_tf32.cuh"

// 3: the 3xTF32 build (libquad); 1: the one-pass TF32 build (libquad_tf32).
#ifndef SAT_QUAD_TF32_PASSES
#define SAT_QUAD_TF32_PASSES 3
#endif
static_assert(SAT_QUAD_TF32_PASSES == 1 || SAT_QUAD_TF32_PASSES == 3,
              "SAT_QUAD_TF32_PASSES is 1 or 3");

namespace {

constexpr bool kOnePass = SAT_QUAD_TF32_PASSES == 1;

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int TN = 64;    // points (rows of x) per tile
constexpr int TK = 64;    // columns of t per tile
constexpr int TI = 16;    // depth of one shared-memory stage of t_tile
constexpr int TW = 256;   // columns of dx, rows of dF, per pass
constexpr int XS = TN + 1;  // padded strides keep shared-memory banks apart
constexpr int WS = TK + 1;
constexpr int FS = TK + 1;
constexpr int XW = TW + 1;

// Shared memory of t_tile: xs[TI][XS] (x staged transposed), fs[TI][TK].
constexpr int kTileFloats = TI * XS + TI * TK;

// acc[r][c] = t[row ty + 16 r, k0 + tx + 16 c] for the 64 rows of x at `x`
// (row-major, stride m; rows >= nrows read as 0) and F (m x m, row-major;
// columns >= m read as 0). Every thread of the block must call it.
__device__ __forceinline__ void t_tile(const float* __restrict__ x, int nrows, int m,
                                       const float* __restrict__ F, int k0,
                                       float (&acc)[4][4], float* xs, float* fs) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  for (int i0 = 0; i0 < m; i0 += TI) {
    for (int t = tid; t < TN * TI; t += kThreads) {
      const int n = t / TI;
      const int ii = t - n * TI;
      xs[ii * XS + n] = (n < nrows && i0 + ii < m) ? x[(size_t)n * m + i0 + ii] : 0.0f;
    }
    for (int t = tid; t < TI * TK; t += kThreads) {
      const int ii = t / TK;
      const int k = t - ii * TK;
      fs[ii * TK + k] =
          (i0 + ii < m && k0 + k < m) ? F[(size_t)(i0 + ii) * m + k0 + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = xs[ii * XS + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = fs[ii * TK + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// ---- The forward: 3xTF32 tensor-core tiles, squared and summed. ----

constexpr int FK = 32;          // depth of one stage
constexpr int FSTAGES = 3;      // stages in flight
constexpr int FXS = FK + 4;     // padded row of the x tile
constexpr int kMaxCluster = 8;  // portable cluster size

// A block of WM x WN warps, each making MT x NT mma tiles (16 x 8) of t:
// BM points by BN columns of t for one channel.
template <int WM_, int WN_, int MT_, int NT_, int MIN_BLOCKS_>
struct FwdTile {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;  // blocks per SM the registers allow
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int BM = WM * MT * 16;
  static constexpr int BN = WN * NT * 8;
  static constexpr int FS = BN + 8;  // padded row of the F tile
  static constexpr int XTS = BM + 8;  // padded depth row of a transposed x tile
  // The x tile, [point][depth] (row-major x) or [depth][point] (x given
  // transposed), then the F tile [depth][column].
  static constexpr int kXTile = BM * FXS > FK * XTS ? BM * FXS : FK * XTS;
  static constexpr int kStage = kXTile + FK * FS;
  // The stages, the row sums of the WN column groups, then the cluster
  // leader's slots for every block's partial sums.
  static constexpr int kRows = FSTAGES * kStage;
  static constexpr int kParts = kRows + WN * BM;
  static constexpr size_t kSmem = (size_t)(kParts + kMaxCluster * BM) * sizeof(float);
};
using FwdLarge = FwdTile<2, 4, 4, 4, 2>;   // 128 x 128, 8 warps of 64 x 32
using FwdMedium = FwdTile<2, 4, 2, 4, 1>;  // 64 x 128, 8 warps of 32 x 32
using FwdSmall = FwdTile<2, 2, 2, 4, 1>;   // 64 x 64, 4 warps of 32 x 32

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of BYTES (4 or 16) that reads the first src_bytes of them and
// zero-fills the rest (with src_bytes 0 the source is only kept valid).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int src_bytes) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo: hi is v cut to TF32 (its top 10 mantissa bits), lo = v - hi
// exactly in fp32, which the tensor core reads to TF32 in turn.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// v rounded to TF32 (nearest, ties away from zero), as the tensor core's operand.
__device__ __forceinline__ unsigned round_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v as a tensor-core operand: its TF32 high and low parts (3xTF32), or in
// the one-pass build v rounded to TF32 in hi (lo is left unset and unread).
__device__ __forceinline__ void tf32_operand(float v, unsigned& hi, unsigned& lo) {
  if constexpr (kOnePass)
    hi = round_tf32(v);
  else
    split_tf32(v, hi, lo);
}

// c += a b on one 16 x 8 x 8 TF32 tile, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the x tile (the block's points, depth i0..i0+FK) and the F tile
// (depth i0..i0+FK, columns k0..k0+BN) into `st`, VEC floats a copy (4
// when m, x's row stride xs and the pointers allow 16-byte copies, else 1).
// Point r, depth c of the block's x is at xg[r * xs + c], or with XT (x
// given transposed) at xg[c * xs + r]. Out-of-range elements are
// zero-filled. XT with VEC 4: depth row c is copied from the 16-byte
// boundary at or below its first point, `shift(c)` = (xalign + (i0 + c) xs)
// mod 4 floats earlier, so point r lands at st[c XTS + shift(c) + r]; the
// copy stops at the row's end (`rowlen` points from xg), and what it brings
// from before the row's start is never read.
template <class T, int VEC, bool XT>
__device__ __forceinline__ void fwd_load(float* st, const float* __restrict__ xg, long long xs,
                                         int xalign, int rowlen, int nrows,
                                         const float* __restrict__ Fb, int m, int k0, int i0) {
  constexpr int XPR = FK / VEC;     // copies per x row
  constexpr int FPR = T::BN / VEC;  // copies per F row
  if (XT && VEC == 4) {
    constexpr int CPR = T::BM / 4 + 1;  // 16-byte copies per depth row
    for (int t = threadIdx.x; t < FK * CPR; t += T::kThreads) {
      const int c = t / CPR;
      const int q = t % CPR;
      const long long start = (i0 + c) * xs;
      const int sh = (int)((xalign + start) & 3);
      const int left = rowlen + sh - 4 * q;  // points of the row from this copy on
      const bool ok = i0 + c < m && left > 0;
      cp_async<16>(st + c * T::XTS + 4 * q, ok ? xg + start - sh + 4 * q : xg,
                   ok ? 4 * min(left, 4) : 0);
    }
  } else if (XT) {
    for (int t = threadIdx.x; t < FK * T::BM; t += T::kThreads) {
      const int c = t / T::BM;
      const int r = t % T::BM;
      const bool ok = r < nrows && i0 + c < m;
      cp_async<4>(st + c * T::XTS + r, ok ? xg + (i0 + c) * xs + r : xg, ok ? 4 : 0);
    }
  } else {
    for (int t = threadIdx.x; t < T::BM * XPR; t += T::kThreads) {
      const int r = t / XPR;
      const int c = (t % XPR) * VEC;
      const bool ok = r < nrows && i0 + c < m;
      cp_async<4 * VEC>(st + r * FXS + c, ok ? xg + r * xs + i0 + c : xg, ok ? 4 * VEC : 0);
    }
  }
  for (int t = threadIdx.x; t < FK * FPR; t += T::kThreads) {
    const int ii = t / FPR;
    const int k = (t % FPR) * VEC;
    const bool ok = i0 + ii < m && k0 + k < m;
    cp_async<4 * VEC>(st + T::kXTile + ii * T::FS + k,
                      ok ? Fb + (size_t)(i0 + ii) * m + k0 + k : Fb, ok ? 4 * VEC : 0);
  }
}

// The raw fp32 fragments of one depth step of 8 for this warp's tiles.
// sh0 and sh1: the shifts of depth rows kk + tig and kk + tig + 4 of a
// transposed x tile (fwd_load).
template <class T, bool XT>
__device__ __forceinline__ void fwd_frags(const float* st, int kk, int wm, int wn, int gid,
                                          int tig, int sh0, int sh1, float (&a)[T::MT][4],
                                          float (&b)[T::NT][2]) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int row = (wm * T::MT + mt) * 16 + gid;
    if (XT) {
      const float* p = st + (kk + tig) * T::XTS + row;
      a[mt][0] = p[sh0];
      a[mt][1] = p[sh0 + 8];
      a[mt][2] = p[4 * T::XTS + sh1];
      a[mt][3] = p[4 * T::XTS + sh1 + 8];
    } else {
      const float* p = st + row * FXS + kk + tig;
      a[mt][0] = p[0];
      a[mt][1] = p[8 * FXS];
      a[mt][2] = p[4];
      a[mt][3] = p[8 * FXS + 4];
    }
  }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const float* p = st + T::kXTile + (kk + tig) * T::FS + (wn * T::NT + nt) * 8 + gid;
    b[nt][0] = p[0];
    b[nt][1] = p[4 * T::FS];
  }
}

// acc += x tile . F tile for this warp's MT x NT mma tiles, over the
// stage's first `depth` rows of F (steps of 8) and the warp's first `ntiles`
// column tiles: steps and tiles wholly past m are skipped. FULL (every step
// and tile) has no condition around an mma: a predicated mma.sync costs a
// warp re-convergence each. Each product is three mma (lo hi, hi lo,
// hi hi; only hi hi in the one-pass build), issued pass by pass so that
// consecutive mma of a warp never wait on each other; the next step's fragments are read from shared memory
// before this step's mma are issued.
template <class T, bool XT, bool FULL>
__device__ __forceinline__ void fwd_mma_stage(const float* st, float (&acc)[T::MT][T::NT][4],
                                              int wm, int wn, int gid, int tig, int depth,
                                              int ntiles, int shbase, int xs4) {
  // The shift of depth row c of a transposed x tile: (shbase + c xs4) mod 4
  // (both 0 unless fwd_load shifted the rows).
  auto shift = [&](int c) { return (shbase + c * xs4) & 3; };
  float ra[T::MT][4], rb[T::NT][2];
  fwd_frags<T, XT>(st, 0, wm, wn, gid, tig, shift(tig), shift(tig + 4), ra, rb);
#pragma unroll
  for (int kk = 0; kk < FK; kk += 8) {
    if (!FULL && kk >= depth) break;
    unsigned ahi[T::MT][4], alo[T::MT][4], bhi[T::NT][2], blo[T::NT][2];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_operand(ra[mt][e], ahi[mt][e], alo[mt][e]);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) tf32_operand(rb[nt][e], bhi[nt][e], blo[nt][e]);
    if (kk + 8 < FK)
      fwd_frags<T, XT>(st, kk + 8, wm, wn, gid, tig, shift(kk + 8 + tig), shift(kk + 12 + tig),
                       ra, rb);
    if constexpr (!kOnePass) {
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          if (FULL || nt < ntiles) mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          if (FULL || nt < ntiles) mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
        if (FULL || nt < ntiles) mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
  }
}

// grid (nk * ceil(N / BM), L, G), clusters of (nk, 1, 1): block
// tile * nk + r makes the column tiles r, r + nk, ... of t for the points
// tile * BM ... of channel blockIdx.y of group blockIdx.z.
template <class T, int VEC, bool XT>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
quad_fwd_kernel(const float* __restrict__ x, long long x_gstride, long long xs,
                const float* __restrict__ F, long long f_gstride, float* __restrict__ out, int N,
                int m, int L, int nk) {
  extern __shared__ float4 fwd_smem4[];
  float* smem = reinterpret_cast<float*>(fwd_smem4);
  float* rows = smem + T::kRows;   // [WN][BM] row sums of the column groups
  float* parts = smem + T::kParts;  // [nk][BM]: the leader's, every block's partial sums
  const int rank = blockIdx.x % nk;
  const int n0 = (blockIdx.x / nk) * T::BM;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int nrows = min(T::BM, N - n0);
  const long long xbase = g * x_gstride + (XT ? n0 : n0 * xs);
  const float* xg = x + xbase;
  // Shifted 16-byte rows of a transposed x tile (x is 16-byte aligned).
  const bool shifted = XT && VEC == 4;
  const int xalign = shifted ? (int)(xbase & 3) : 0;
  const int xs4 = shifted ? (int)(xs & 3) : 0;
  const float* Fb = F + g * f_gstride + (size_t)b * m * m;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wm = warp % T::WM;
  const int wn = warp / T::WM;
  const int KT = (m + FK - 1) / FK;
  // Distributed shared memory may be written only once every block of the
  // cluster runs: arrive now, wait just before the epilogue's remote stores.
  if (nk > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float sq[T::MT][2];  // rows gid and gid + 8 of each m tile
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) sq[mt][0] = sq[mt][1] = 0.0f;
  for (int k0 = rank * T::BN; k0 < m; k0 += nk * T::BN) {
    // This warp's column tiles of 8 that reach into the m columns of t.
    const int ntiles = min(T::NT, max(0, (m - k0 - wn * T::NT * 8 + 7) / 8));
    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    __syncthreads();  // the stages are free again
#pragma unroll
    for (int s = 0; s < FSTAGES - 1; ++s) {
      if (s < KT)
        fwd_load<T, VEC, XT>(smem + s * T::kStage, xg, xs, xalign, N - n0, nrows, Fb, m, k0,
                             s * FK);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<FSTAGES - 2>();
      __syncthreads();  // stage kt has landed; stage kt - 1 is consumed
      const int next = kt + FSTAGES - 1;
      if (next < KT)
        fwd_load<T, VEC, XT>(smem + (next % FSTAGES) * T::kStage, xg, xs, xalign, N - n0, nrows,
                             Fb, m, k0, next * FK);
      cp_async_commit();
      const float* st = smem + (kt % FSTAGES) * T::kStage;
      const int depth = m - kt * FK;
      const int shbase = (int)((xalign + (long long)kt * FK * xs4) & 3);
      if (depth >= FK && ntiles == T::NT)
        fwd_mma_stage<T, XT, true>(st, acc, wm, wn, gid, tig, depth, ntiles, shbase, xs4);
      else if (ntiles > 0)
        fwd_mma_stage<T, XT, false>(st, acc, wm, wn, gid, tig, depth, ntiles, shbase, xs4);
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const float* a = acc[mt][nt];
        sq[mt][0] = fmaf(a[0], a[0], sq[mt][0]);
        sq[mt][0] = fmaf(a[1], a[1], sq[mt][0]);
        sq[mt][1] = fmaf(a[2], a[2], sq[mt][1]);
        sq[mt][1] = fmaf(a[3], a[3], sq[mt][1]);
      }
  }
  cp_async_wait<0>();
  // The 4 lanes of a row are lanes 4 gid .. 4 gid + 3.
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sq[mt][h] += __shfl_xor_sync(0xffffffffu, sq[mt][h], 1);
      sq[mt][h] += __shfl_xor_sync(0xffffffffu, sq[mt][h], 2);
    }
  if (tig == 0) {
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      float* rw = rows + wn * T::BM + (wm * T::MT + mt) * 16 + gid;
      rw[0] = sq[mt][0];
      rw[8] = sq[mt][1];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  float s = 0.0f;  // the block's partial sum of row t, column groups in order
  if (t < T::BM) {
    s = rows[t];
#pragma unroll
    for (int w = 1; w < T::WN; ++w) s += rows[w * T::BM + t];
  }
  float* o = out + ((size_t)g * L + b) * N + n0;
  if (nk == 1) {
    if (t < nrows) o[t] = s;
    return;
  }
  // Each block stores its partial sums into the leader's slots; after one
  // cluster barrier the leader adds them in rank order.
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t < T::BM) cluster.map_shared_rank(parts, 0)[rank * T::BM + t] = s;
  cluster.sync();
  if (rank == 0 && t < nrows) {
    float total = 0.0f;
    for (int q = 0; q < nk; ++q) total += parts[q * T::BM + t];
    o[t] = total;
  }
}

// Dynamic shared memory: t_tile's buffers, ws[TN][WS], fsub[TW][FS].
constexpr size_t kDxSmem = (size_t)(kTileFloats + TN * WS + TW * FS) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
quad_dx_kernel(const float* __restrict__ x, const float* __restrict__ F,
               long long f_gstride, const float* __restrict__ dy,
               float* __restrict__ dx, int N, int m, int L) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* fs = xs + TI * XS;
  float* ws = fs + TI * TK;
  float* fsub = ws + TN * WS;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * TN;
  const int g = blockIdx.y;
  const int nrows = min(TN, N - n0);
  const float* xg = x + ((size_t)g * N + n0) * m;
  for (int is0 = 0; is0 < m; is0 += TW) {
    float dxa[4][16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) dxa[r][c] = 0.0f;
    for (int b = 0; b < L; ++b) {
      const float* Fb = F + g * f_gstride + (size_t)b * m * m;
      const float* dyb = dy + ((size_t)g * L + b) * N + n0;
      float dy2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dy2[r] = (ty + 16 * r < nrows) ? 2.0f * dyb[ty + 16 * r] : 0.0f;
      for (int k0 = 0; k0 < m; k0 += TK) {
        float acc[4][4];
        t_tile(xg, nrows, m, Fb, k0, acc, xs, fs);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ws[(ty + 16 * r) * WS + tx + 16 * c] = dy2[r] * acc[r][c];
        for (int t = tid; t < TW * TK; t += kThreads) {
          const int ii = t / TK;
          const int k = t - ii * TK;
          fsub[ii * FS + k] =
              (is0 + ii < m && k0 + k < m) ? Fb[(size_t)(is0 + ii) * m + k0 + k] : 0.0f;
        }
        __syncthreads();
        for (int k = 0; k < TK; ++k) {
          float a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = ws[(ty + 16 * r) * WS + k];
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const float f = fsub[(tx + 16 * c) * FS + k];
#pragma unroll
            for (int r = 0; r < 4; ++r) dxa[r][c] = fmaf(a[r], f, dxa[r][c]);
          }
        }
        __syncthreads();  // ws and fsub are rewritten by the next k-tile
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int i = is0 + tx + 16 * c;
        if (n < nrows && i < m) dx[((size_t)g * N + n0 + n) * m + i] = dxa[r][c];
      }
    }
  }
}

// Dynamic shared memory: t_tile's buffers, ws[TN][WS], xsub[TN][XW].
constexpr size_t kDfSmem = (size_t)(kTileFloats + TN * WS + TN * XW) * sizeof(float);

// Rows of factor group fg are the flat rows [fg * rows_fg, (fg + 1) * rows_fg)
// of x viewed as (G * N, m): all G * N rows when F is shared (one group),
// the N rows of group fg otherwise. Split s takes the contiguous range
// [s * per_split, (s + 1) * per_split) of them.
__global__ void __launch_bounds__(kThreads)
quad_df_kernel(const float* __restrict__ x, const float* __restrict__ F,
               long long f_gstride, const float* __restrict__ dy,
               float* __restrict__ partial, int N, int m, int L, int n_groups,
               long long rows_fg, long long per_split) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* fs = xs + TI * XS;
  float* ws = fs + TI * TK;
  float* xsub = ws + TN * WS;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * TK;
  const int b = blockIdx.y;
  const int fg = blockIdx.z % n_groups;
  const int split = blockIdx.z / n_groups;
  const float* Fb = F + fg * f_gstride + (size_t)b * m * m;
  const long long lo = fg * rows_fg + split * per_split;
  const long long hi = min(lo + per_split, (fg + 1) * rows_fg);
  float* out = partial + (((size_t)split * n_groups + fg) * L + b) * (size_t)m * m;
  for (int is0 = 0; is0 < m; is0 += TW) {
    float dfa[16][4];
#pragma unroll
    for (int a = 0; a < 16; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dfa[a][c] = 0.0f;
    for (long long r0 = lo; r0 < hi; r0 += TN) {
      const int nrows = (int)min((long long)TN, hi - r0);
      float acc[4][4];
      t_tile(x + r0 * m, nrows, m, Fb, k0, acc, xs, fs);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = ty + 16 * r;
        float dy2 = 0.0f;
        if (n < nrows) {
          const long long row = r0 + n;  // flat row g * N + point
          const long long g = row / N;
          dy2 = 2.0f * dy[((size_t)g * L + b) * N + (row - g * N)];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) ws[n * WS + tx + 16 * c] = dy2 * acc[r][c];
      }
      for (int t = tid; t < TN * TW; t += kThreads) {
        const int n = t / TW;
        const int ii = t - n * TW;
        xsub[n * XW + ii] =
            (n < nrows && is0 + ii < m) ? x[(size_t)(r0 + n) * m + is0 + ii] : 0.0f;
      }
      __syncthreads();
      for (int n = 0; n < TN; ++n) {
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = ws[n * WS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 16; ++a) {
          const float xv = xsub[n * XW + ty + 16 * a];
#pragma unroll
          for (int c = 0; c < 4; ++c) dfa[a][c] = fmaf(xv, w[c], dfa[a][c]);
        }
      }
      __syncthreads();  // ws and xsub are rewritten by the next rows
    }
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const int i = is0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = k0 + tx + 16 * c;
        if (i < m && k < m) out[(size_t)i * m + k] = dfa[a][c];
      }
    }
  }
}

__global__ void quad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dF,
                                long long total, int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int p = 0; p < splits; ++p) s += partial[p * total + e];
    dF[e] = s;
  }
}

// ---- The backward: two chained 3xTF32 products a chunk. ----

constexpr int BWARPS = 8;            // warps of a backward block
constexpr int BTHREADS = BWARPS * 32;
constexpr int BC = 32;               // depth of a chunk: columns of t (dx), points (dF)
constexpr int BNT = BC / 8;          // mma column tiles of t in a chunk
constexpr int BFD = BC + 8;          // padded row of dx's F chunk, = 8 mod 16
constexpr int kMaxBwdM = 512;        // widest m of the tensor-core backward
constexpr int kMaxBlockSmem = 232448;  // bytes of shared memory a block may have

// NI mma column tiles of 8 cover the m columns of the accumulator: IP = 8 NI
// >= m. P warps share a group of 16 rows, each keeping NI / P of the
// accumulator's column tiles and making BNT / P of each chunk's tiles of t:
// R = 16 * BWARPS / P resident rows. x rows are padded to XS = IP + 4
// floats (= 4 mod 8), rows of dF's F slab to FF = R + 8 (= 8 mod 16).
template <bool DF, int NI, int P>
struct Bwd {
  static constexpr int IP = NI * 8;
  static constexpr int XS = IP + 4;
  static constexpr int R = BWARPS / P * 16;
  static constexpr int FF = R + 8;
  static constexpr int NW = NI / P;   // accumulator column tiles a warp
  static constexpr int TW = BNT / P;  // tiles of t a warp makes a chunk
  // The resident tile, then the chunk buffers, each followed by its 2 dy
  // values (R of them for dx: one per row; BC for dF: one per point), then
  // (P > 1) the exchange of w, [row group][tile of t][lane][4]. Three
  // buffers when they fit in a block's shared memory (two chunks in flight
  // while one is used), else two, else one.
  static constexpr int kResident = DF ? IP * FF : R * XS;
  static constexpr int kChunk = (DF ? BC * XS : IP * BFD) + (DF ? BC : R);
  static constexpr int kSwap = P > 1 ? BWARPS / P * BNT * 128 : 0;
  static constexpr int kStages = (kResident + 3 * kChunk + kSwap) * 4 <= kMaxBlockSmem   ? 3
                                 : (kResident + 2 * kChunk + kSwap) * 4 <= kMaxBlockSmem ? 2
                                                                                         : 1;
  static constexpr size_t kSmem = (size_t)(kResident + kStages * kChunk + kSwap) * sizeof(float);
  static_assert(NI % P == 0 && BNT % P == 0, "the warps of a row group split evenly");
  static_assert(kSmem <= kMaxBlockSmem, "one chunk buffer must fit");
};

// mma tiles of the second product issued together: independent accumulators
// between two that depend on each other.
constexpr int kGroup = 4;

// w's TF32 parts of one tile of t as an A fragment, from the 4 values w
// (hi alone, rounded, in the one-pass build).
__device__ __forceinline__ void split4(const float (&w)[4], unsigned (&hi)[4], unsigned (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) tf32_operand(w[e], hi[e], lo[e]);
}

// One chunk for the warp `h` of row group `rg`: s = A . B over depth m8 for
// the warp's TW column tiles of 8, w = 2 dy s, acc += w . B^T over the
// warp's NW accumulator column tiles. A is the resident tile (dx: x
// [row][i], ld XS; dF: F slab [i][row], ld FF); B the chunk (dx: F chunk
// [i][c], ld BFD; dF: x chunk [c][i], ld XS); dys the chunk's dy values;
// swap the exchange of w (P > 1). Only the first `nv` column tiles of the
// chunk hold data (columns past m, points past the range): FULL chunks
// (nv == BNT) run without a condition around an mma, the last one skips
// the empty tiles.
template <bool DF, int NI, int P, bool FULL>
__device__ __forceinline__ void bwd_chunk(const float* As, const float* Bs, const float* dys,
                                          float* swap, int m8, int nv, int rg, int h, int gid,
                                          int tig, int lane, float (&acc)[NI / P][4]) {
  using T = Bwd<DF, NI, P>;
  constexpr int TW = T::TW;
  constexpr int NW = T::NW;
  const int t0 = h * TW;  // the warp's first column tile of t
  float s[TW][4];
#pragma unroll
  for (int q = 0; q < TW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[q][e] = 0.0f;
  const int r = rg * 16 + gid;
  // s += A . B over the depth step kk..kk+8, into sa.
  auto step = [&](int kk, float (&sa)[TW][4]) {
    float a[4], b[TW][2];
    if (DF) {
      const float* p = As + (kk + tig) * T::FF + r;
      a[0] = p[0];
      a[1] = p[8];
      a[2] = p[4 * T::FF];
      a[3] = p[4 * T::FF + 8];
    } else {
      const float* p = As + r * T::XS + kk + tig;
      a[0] = p[0];
      a[1] = p[8 * T::XS];
      a[2] = p[4];
      a[3] = p[8 * T::XS + 4];
    }
#pragma unroll
    for (int q = 0; q < TW; ++q) {
      const int nt = t0 + q;
      if (DF) {
        const float* p = Bs + (nt * 8 + gid) * T::XS + kk + tig;
        b[q][0] = p[0];
        b[q][1] = p[4];
      } else {
        const float* p = Bs + (kk + tig) * BFD + nt * 8 + gid;
        b[q][0] = p[0];
        b[q][1] = p[4 * BFD];
      }
    }
    unsigned ahi[4], alo[4], bhi[TW][2], blo[TW][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_operand(a[e], ahi[e], alo[e]);
#pragma unroll
    for (int q = 0; q < TW; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) tf32_operand(b[q][e], bhi[q][e], blo[q][e]);
    if constexpr (!kOnePass) {
#pragma unroll
      for (int q = 0; q < TW; ++q)
        if (FULL || t0 + q < nv) mma_tf32(sa[q], alo, bhi[q]);
#pragma unroll
      for (int q = 0; q < TW; ++q)
        if (FULL || t0 + q < nv) mma_tf32(sa[q], ahi, blo[q]);
    }
#pragma unroll
    for (int q = 0; q < TW; ++q)
      if (FULL || t0 + q < nv) mma_tf32(sa[q], ahi, bhi[q]);
  };
  if (P == 1) {
#pragma unroll 4
    for (int kk = 0; kk < m8; kk += 8) step(kk, s);
  } else {
    // Half the tiles a warp: two chains a tile, the even and the odd depth
    // steps, added at the end (the resident tile and the chunk are
    // zero-filled to IP >= m rounded up to 16).
    float s2[TW][4];
#pragma unroll
    for (int q = 0; q < TW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) s2[q][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < m8; kk += 16) {
      step(kk, s);
      step(kk + 8, s2);
    }
#pragma unroll
    for (int q = 0; q < TW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[q][e] += s2[q][e];
  }
  // w = 2 dy t. The tile's lane holds rows gid, gid + 8 and columns 2 tig,
  // 2 tig + 1; as an A fragment of the second product, whose depth is those
  // columns, they are taken in that order: a = (w[gid][2tig], w[gid+8][2tig],
  // w[gid][2tig+1], w[gid+8][2tig+1]).
  unsigned whi[BNT][4], wlo[BNT][4];
#pragma unroll
  for (int q = 0; q < TW; ++q) {
    const int nt = t0 + q;
    float w[4];
    if (DF) {
      const float d0 = 2.0f * dys[nt * 8 + 2 * tig];
      const float d1 = 2.0f * dys[nt * 8 + 2 * tig + 1];
      w[0] = d0 * s[q][0];
      w[1] = d0 * s[q][2];
      w[2] = d1 * s[q][1];
      w[3] = d1 * s[q][3];
    } else {
      const float d0 = 2.0f * dys[r];
      const float d1 = 2.0f * dys[r + 8];
      w[0] = d0 * s[q][0];
      w[1] = d1 * s[q][2];
      w[2] = d0 * s[q][1];
      w[3] = d1 * s[q][3];
    }
    if (P == 1)
      split4(w, whi[q], wlo[q]);
    else
      *reinterpret_cast<float4*>(swap + ((rg * BNT + nt) * 32 + lane) * 4) =
          make_float4(w[0], w[1], w[2], w[3]);
  }
  if (P > 1) {
    // Every tile of w, the partners' and this warp's own, lane by lane from
    // the exchange once the row group's warps have written theirs.
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(P * 32) : "memory");
#pragma unroll
    for (int j = 0; j < BNT; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(swap + ((rg * BNT + j) * 32 + lane) * 4);
      const float w[4] = {v.x, v.y, v.z, v.w};
      split4(w, whi[j], wlo[j]);
    }
  }
  // acc[:, i] += sum_c w[:, c] B[i][c]; B fragment of column tile ni, depth
  // step j: (B[8 ni + gid][8 j + 2 tig], B[8 ni + gid][8 j + 2 tig + 1]).
  const int i0 = h * NW * 8 + gid;  // the warp's first accumulator column, + gid
#pragma unroll
  for (int j = 0; j < BNT; ++j) {
    if (!FULL && j >= nv) break;
#pragma unroll
    for (int n0 = 0; n0 < NW; n0 += kGroup) {
      unsigned bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (n0 + q < NW) {
          const int i = i0 + (n0 + q) * 8;
          float v0, v1;
          if (DF) {
            v0 = Bs[(j * 8 + 2 * tig) * T::XS + i];
            v1 = Bs[(j * 8 + 2 * tig + 1) * T::XS + i];
          } else {
            const float2 v = *reinterpret_cast<const float2*>(Bs + i * BFD + j * 8 + 2 * tig);
            v0 = v.x;
            v1 = v.y;
          }
          tf32_operand(v0, bh[q][0], bl[q][0]);
          tf32_operand(v1, bh[q][1], bl[q][1]);
        }
      }
      if constexpr (!kOnePass) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (n0 + q < NW) mma_tf32(acc[n0 + q], wlo[j], bh[q]);
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (n0 + q < NW) mma_tf32(acc[n0 + q], whi[j], bl[q]);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (n0 + q < NW) mma_tf32(acc[n0 + q], whi[j], bh[q]);
    }
  }
}

// dx: grid (ceil(N / R), splits, G). Block (tile, split, g) owns the R
// points tile * R ... of group g and the chunks [j0, j1) of the L * nkc
// (channel, column block) chunks, in order; it writes its partial sum of dx
// to out + split * out_split. dF: grid (ceil(m / R), L, splits * n_groups).
// Block (kt, b, split * n_groups + fg) owns columns kt * R ... of dF_b for
// factor group fg over the flat rows [lo, hi) of x viewed as (G N, m) (the
// group's rows, split in ranges of `per` chunks of BC), and writes its
// partial sum to out + (split * n_groups + fg) * L m^2 + b m^2.
template <bool DF, int NI, int P, int VEC>
__global__ void __launch_bounds__(BTHREADS, 1)
quad_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ F,
                   long long f_gstride, const float* __restrict__ dy, float* __restrict__ out,
                   long long out_split, int N, int m, int L, int n_groups, long long rows_fg,
                   int per) {
  using T = Bwd<DF, NI, P>;
  constexpr int R = T::R;
  extern __shared__ float4 bwd_smem4[];
  float* smem = reinterpret_cast<float*>(bwd_smem4);
  float* As = smem;
  float* swap = smem + T::kResident + T::kStages * T::kChunk;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rg = warp / P;  // row group
  const int h = warp % P;   // the warp's share of the row group's columns
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int m8 = (m + 7) / 8 * 8;
  const int nkc = (m + BC - 1) / BC;

  // This block's work, and the operand that stays resident.
  int g = 0, b = 0, fg = 0, split, n0 = 0, k0 = 0, nrows = 0, j0, j1;
  long long lo = 0, hi = 0;
  const float* Fb = F;
  if (DF) {
    k0 = blockIdx.x * R;
    b = blockIdx.y;
    fg = blockIdx.z % n_groups;
    split = blockIdx.z / n_groups;
    lo = fg * rows_fg + (long long)split * per * BC;
    hi = min(lo + (long long)per * BC, (fg + 1) * rows_fg);
    j0 = 0;
    j1 = hi > lo ? (int)((hi - lo + BC - 1) / BC) : 0;
    Fb = F + fg * f_gstride + (size_t)b * m * m;
    for (int t = tid; t < T::IP * R / VEC; t += BTHREADS) {
      const int i = t / (R / VEC);
      const int k = t % (R / VEC) * VEC;
      const bool ok = i < m && k0 + k < m;
      cp_async<4 * VEC>(As + i * T::FF + k, ok ? Fb + (size_t)i * m + k0 + k : Fb,
                        ok ? 4 * VEC : 0);
    }
  } else {
    n0 = blockIdx.x * R;
    split = blockIdx.y;
    g = blockIdx.z;
    nrows = min(R, N - n0);
    j0 = split * per;
    j1 = min(j0 + per, L * nkc);
    const float* xg = x + ((size_t)g * N + n0) * m;
    for (int t = tid; t < R * T::IP / VEC; t += BTHREADS) {
      const int r = t / (T::IP / VEC);
      const int i = t % (T::IP / VEC) * VEC;
      const bool ok = r < nrows && i < m;
      cp_async<4 * VEC>(As + r * T::XS + i, ok ? xg + (size_t)r * m + i : xg, ok ? 4 * VEC : 0);
    }
  }

  // Stage chunk j into buffer `buf`.
  auto load = [&](int j, int buf) {
    float* Bs = smem + T::kResident + buf * T::kChunk;
    float* ds = Bs + (DF ? BC * T::XS : T::IP * BFD);
    if (DF) {
      const long long r0 = lo + (long long)j * BC;
      for (int t = tid; t < BC * T::IP / VEC; t += BTHREADS) {
        const int c = t / (T::IP / VEC);
        const int i = t % (T::IP / VEC) * VEC;
        const bool ok = r0 + c < hi && i < m;
        cp_async<4 * VEC>(Bs + c * T::XS + i, ok ? x + (size_t)(r0 + c) * m + i : x,
                          ok ? 4 * VEC : 0);
      }
      if (tid < BC) {
        const long long row = r0 + tid;  // flat row gq * N + point
        const bool ok = row < hi;
        const long long gq = ok ? row / N : 0;
        const float* src = dy + (size_t)(gq * L + b) * N + (ok ? row - gq * N : 0);
        cp_async<4>(ds + tid, src, ok ? 4 : 0);
      }
    } else {
      const int bj = j / nkc;
      const int c0 = (j - bj * nkc) * BC;
      const float* Fj = F + g * f_gstride + (size_t)bj * m * m;
      for (int t = tid; t < T::IP * BC / VEC; t += BTHREADS) {
        const int i = t / (BC / VEC);
        const int c = t % (BC / VEC) * VEC;
        const bool ok = i < m && c0 + c < m;
        cp_async<4 * VEC>(Bs + i * BFD + c, ok ? Fj + (size_t)i * m + c0 + c : Fj,
                          ok ? 4 * VEC : 0);
      }
      if (tid < R) {
        const bool ok = tid < nrows;
        const float* src = dy + ((size_t)g * L + bj) * N + n0 + (ok ? tid : 0);
        cp_async<4>(ds + tid, src, ok ? 4 : 0);
      }
    }
  };

  float acc[T::NW][4];
#pragma unroll
  for (int ni = 0; ni < T::NW; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;
  // A row group whose 16 rows all lie past the edge only stages and waits.
  const bool active = DF ? k0 + rg * 16 < m : rg * 16 < nrows;
  constexpr int S = T::kStages;
#pragma unroll
  for (int q = 0; q < S - 1; ++q) {
    if (j0 + q < j1) load(j0 + q, q);
    cp_async_commit();
  }
  for (int j = j0; j < j1; ++j) {
    if constexpr (S == 1) {
      // One buffer: every warp is done with chunk j - 1 before chunk j
      // (and, the first time, the resident tile) is staged and awaited.
      __syncthreads();
      load(j, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait<S - 2>();
      // Chunk j (and the resident tile) has landed for every thread, and
      // every warp is done with chunk j - 1, whose buffer takes chunk j + S - 1.
      __syncthreads();
      if (j + S - 1 < j1) load(j + S - 1, (j + S - 1 - j0) % S);
      cp_async_commit();
    }
    const float* Bs = smem + T::kResident + ((j - j0) % S) * T::kChunk;
    // Column tiles of this chunk that hold data (columns < m; points < hi).
    const int nv = DF ? (int)min((long long)BNT, (hi - lo - (long long)j * BC + 7) / 8)
                      : min(BNT, (m - (j % nkc) * BC + 7) / 8);
    const float* ds = Bs + (DF ? BC * T::XS : T::IP * BFD);
    if (active && nv == BNT)
      bwd_chunk<DF, NI, P, true>(As, Bs, ds, swap, m8, nv, rg, h, gid, tig, lane, acc);
    else if (active)
      bwd_chunk<DF, NI, P, false>(As, Bs, ds, swap, m8, nv, rg, h, gid, tig, lane, acc);
  }
  cp_async_wait<0>();

  // Rows rg * 16 + gid (+ 8), columns 8 (h NW + ni) + 2 tig (+ 1) of the
  // accumulator.
  const int r = rg * 16 + gid;
  const int c0 = h * T::NW * 8 + 2 * tig;
  if (DF) {
    float* o = out + (size_t)(split * n_groups + fg) * out_split + (size_t)b * m * m;
#pragma unroll
    for (int ni = 0; ni < T::NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + r + (e >> 1) * 8;
        const int i = c0 + ni * 8 + (e & 1);
        if (k < m && i < m) o[(size_t)i * m + k] = acc[ni][e];
      }
  } else {
    float* o = out + (size_t)split * out_split + ((size_t)g * N + n0) * m;
#pragma unroll
    for (int ni = 0; ni < T::NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = r + (e >> 1) * 8;
        const int i = c0 + ni * 8 + (e & 1);
        if (n < nrows && i < m) o[(size_t)n * m + i] = acc[ni][e];
      }
  }
}

// ---- The one-pass build at m <= 256, m % 4 == 0: warpgroup MMA. ----
//
// Three kernels, each a block of two warpgroups (256 threads, so up to 255
// registers a thread), each running wgmma on 64 of the block's 128
// resident rows. A ring of kStages slots, each one 32-deep slice of a
// streamed operand, is filled by bulk copies (cp.async.bulk: the TMA
// engine, 1-D) that one thread issues under an mbarrier a slot, `full` (one
// arrival with the slot's byte count; the phase completes when the copies
// have landed), and a count of the warps done with the slot: the last of
// the 8 to release it refills it at once with the slice kStages on, so
// copies run kStages slices ahead of the products and no warp waits to
// refill. Every operand lies in shared memory K-major (the one layout wgmma
// reads 32-bit operands in), cut into 32-deep slices of 128-byte rows with
// the 128-byte swizzle (tile_off, smem_desc), and rounded to TF32 (cvt.rna)
// before wgmma reads it, since wgmma drops the low bits. quad_prep_kernel
// writes F, and for the backward x, rounded and already in that layout,
// slice after slice, so that one bulk copy fills a slot or a slice of the
// resident tile. Two operands come otherwise: the forward's resident x
// (read where it lies, through registers, rounded on the way: the forward
// makes no copy of x) and the 2 dy of a chunk (4-byte cp.async).

constexpr int kWgThreads = 128;            // a warpgroup
constexpr int kWgBlock = 2 * kWgThreads;   // two warpgroups
constexpr int kWgRows = 128;               // resident rows of a block; points of a dF chunk
constexpr int kWgSlice = 32;               // depth of a ring slot
constexpr int kWgMaxM = 256;
constexpr int kWgBarBytes = 1024;          // the mbarriers, then the resident tile

#if SAT_QUAD_TF32_PASSES == 1  // (the 3xTF32 build compiles none of what follows)

// Rows of a tile keep their index order within each group of 8 except for
// one permutation: position p holds index 8 (p / 8) + sigma(p % 8), sigma =
// (0 4 1 5 2 6 3 7). A wgmma accumulator lane holds columns 2 tig and
// 2 tig + 1 where the A fragment of the next product wants depth tig and
// tig + 4; with this order those two columns are indices tig and tig + 4,
// so t feeds the second product from its own registers and that product's
// B operand stays in index order.
__device__ __forceinline__ int sigma8(int p) {
  const int q = p & 7;
  return (p & ~7) | ((q & 1) ? 4 + (q >> 1) : (q >> 1));
}

// NP: the accumulator's width, m rounded up to 64, 128, 200 or 256 (the
// columns of dx, dF^T and t). NH: half of NP rounded up to 8; NT = 2 NH >=
// NP rows in a tile of F^T. NX: the dx pass's chunk, columns of F: all NP
// (t beside the accumulator, 100 + 100 registers at m = 200), or NH where
// two of NP would not fit (m = 256); kHalves chunks a channel. A slot holds up
// to kSlotRows rows of one slice (128 values of 2 dy beside it); the
// resident tile 128 rows, NP rounded up to 32 deep. Slots and slices start
// on 1 KB, as the swizzle wants.
template <int NP>
struct Wg {
  static constexpr int NH = (NP / 2 + 7) / 8 * 8;
  static constexpr int NT = 2 * NH;
  static constexpr int NX = NP <= 200 ? NP : NH;
  static constexpr int kHalves = NP <= 200 ? 1 : 2;
  static constexpr int kSlotRows = NT > kWgRows ? NT : kWgRows;
  static constexpr int kSlotBytes = (kSlotRows * 128 + 1023) / 1024 * 1024;
  static constexpr int kQBytes = kWgRows * ((NP + 31) / 32 * 32) * 4;
  static constexpr int kFree = kMaxBlockSmem - kWgBarBytes - kQBytes;
  static constexpr int kStages = kFree / (kSlotBytes + 512) < 4 ? kFree / (kSlotBytes + 512) : 4;
  static constexpr size_t kSmem =
      (size_t)kWgBarBytes + kQBytes + kStages * (kSlotBytes + 512);
  static_assert(kStages >= 2, "two slots must fit beside the resident tile");
};

// Element (r, k) of a tile of `rows` rows (a multiple of 8), in floats: the
// 32-deep slices one after another, each a 128-byte row a row, the 16-byte
// pieces of row r in the order k / 4 xor r % 8 (8 rows: 1 KB).
__device__ __forceinline__ int tile_off(int r, int k, int rows) {
  return (k / 32) * rows * 32 + (r / 8) * 256 + (r % 8) * 32 + ((k % 32 / 4) ^ (r % 8)) * 4 +
         (k % 4);
}

// The wgmma descriptor of the 8-deep step t of a tile of `rows` rows at
// shared address `addr` (K-major, 128-byte swizzle: 8 rows 1 KB apart; the
// step 32 bytes into its slice's rows).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int rows, int t) {
  const uint32_t a = addr + (t / 4) * rows * 128 + (t % 4) * 32;
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that outlasts
// 10 s traps, so that a broken ring ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  unsigned long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (spin == 0) t0 = now;
    else if (now - t0 > 10000000000ULL) asm volatile("trap;\n");
  }
}

// This thread's arrival, and `bytes` more for the phase to wait for.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The phase cannot complete before this thread's cp.async copies so far
// have landed (they hold back an arrival that follows).
__device__ __forceinline__ void mbar_track_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` (a multiple of 16) from `src` to shared memory at `dst` by the TMA
// engine, counted against the barrier's expected bytes.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// This thread's stores to shared memory, visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The warp's index, and one lane of it, in forms ptxas knows to be uniform
// across the warp: a divergent branch between two products makes it
// serialize them.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
}

__device__ __forceinline__ bool elect_one() {
  uint32_t pred = 0;
  asm volatile(
      "{\n.reg .b32 rx;\n.reg .pred px;\nelect.sync rx|px, %1;\n@px mov.s32 %0, 1;\n}\n"
      : "+r"(pred)
      : "r"(0xffffffffu));
  return pred != 0;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma writes or reads: the compiler must
// neither read them early nor reuse them before this point (after a wait).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The accumulator products of each width (wgmma_tf32.cuh).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_ss_n128(d, a, b, scale_d);
  else if constexpr (N == 200) wgmma_ss_n200(d, a, b, scale_d);
  else wgmma_ss_n256(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a[0], a[1], a[2], a[3], b, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a[0], a[1], a[2], a[3], b, 1);
  else if constexpr (N == 200) wgmma_rs_n200(d, a[0], a[1], a[2], a[3], b, 1);
  else wgmma_rs_n256(d, a[0], a[1], a[2], a[3], b, 1);
}

// 4 bytes from `src` into shared memory at `dst`, or 4 zero bytes (`ok`
// false; `any` is a valid address that is not read).
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool ok, const float* any) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(ok ? src : any),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ float rna(float v) { return __uint_as_float(round_tf32(v)); }

// The block's shared memory: barriers (full[s] at 8 s, the resident tile's
// at 128), the count of warps done with slot s (at 64 + 4 s), the resident
// tile, the ring.
template <int NP>
struct WgSmem {
  uint32_t base;
  unsigned char* ptr;
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ int* done(int s) const { return reinterpret_cast<int*>(ptr + 64 + 4 * s); }
  __device__ uint32_t qbar() const { return base + 128; }
  __device__ uint32_t q() const { return base + kWgBarBytes; }
  __device__ float* qf() const { return reinterpret_cast<float*>(ptr + kWgBarBytes); }
  __device__ uint32_t slot(int s) const {
    return base + kWgBarBytes + Wg<NP>::kQBytes + s * Wg<NP>::kSlotBytes;
  }
  __device__ uint32_t dy(int s) const {
    return base + kWgBarBytes + Wg<NP>::kQBytes + Wg<NP>::kStages * Wg<NP>::kSlotBytes + 512 * s;
  }
  __device__ const float* dyf(int s) const {
    return reinterpret_cast<const float*>(ptr + kWgBarBytes + Wg<NP>::kQBytes +
                                          Wg<NP>::kStages * Wg<NP>::kSlotBytes + 512 * s);
  }
};

template <int NP>
__device__ __forceinline__ WgSmem<NP> wg_setup(unsigned char* smem) {
  WgSmem<NP> sm{smem_addr(smem), smem};
  if (threadIdx.x == 0) {
    for (int s = 0; s < Wg<NP>::kStages; ++s) {
      mbar_init(sm.full(s), 1);
      *sm.done(s) = 0;
    }
    mbar_init(sm.qbar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

template <int NP>
__device__ __forceinline__ void wg_wait_full(const WgSmem<NP>& sm, int q) {
  constexpr int S = Wg<NP>::kStages;
  mbar_wait(sm.full(q % S), (q / S) & 1);
}

// A warp is done reading slice q (slot q % S); the last of the block's 8
// refills the slot with slice q + S (fill: every lane of that warp).
template <int NP, class Fill>
__device__ __forceinline__ void wg_release(const WgSmem<NP>& sm, int q, Fill& fill) {
  constexpr int S = Wg<NP>::kStages;
  int last = 0;
  if (elect_one()) last = atomicAdd(sm.done(q % S), 1) == kWgBlock / 32 - 1;
  last = __shfl_sync(0xffffffffu, __reduce_or_sync(0xffffffffu, last), 0);
  if (last) {
    *sm.done(q % S) = 0;
    fill(q + S);
  }
}

// t = Q B^T for the warpgroup's 64 rows of the resident tile Q (depth kp:
// m rounded up to 8) and the ring's next ceil(kp / 32) slices, each NB rows.
// Releases the slices once read; returns with t complete in registers.
template <int NP, int NB, class Fill>
__device__ __forceinline__ void wg_first_product(const WgSmem<NP>& sm, int& q, int kp, int cw,
                                                 float (&t)[NB / 2], Fill& fill) {
  const uint32_t qa = sm.q() + cw * 8 * 1024;
  const int ns = (kp + kWgSlice - 1) / kWgSlice;
  for (int s = 0; s < ns; ++s, ++q) {
    wg_wait_full(sm, q);
    const int steps = min(kWgSlice, kp - s * kWgSlice) / 8;
    const uint32_t b = sm.slot(q % Wg<NP>::kStages);
    wgmma_fence();
    for (int kk = 0; kk < steps; ++kk)
      wgmma_ss<NB>(t, smem_desc(qa, kWgRows, 4 * s + kk), smem_desc(b, NB, kk), s + kk > 0);
    wgmma_commit();
    if (s > 0) {
      wgmma_wait<1>();
      wg_release(sm, q - 1, fill);
    }
  }
  wgmma_wait<0>();
  keep(t);
  wg_release(sm, q - 1, fill);
}

// Forward, grid (ceil(N / 128), splits, G): block (tile, split, g) makes
// out[g, b, n] for the tile's 128 points and the channels b of its split.
// x (G, N, m) at any strides, read where it lies; FT: quad_prep_kernel's
// tiles of F_b^T (ft_gstride floats a group, 0 for a shared F).
template <int NP>
__global__ void __launch_bounds__(kWgBlock, 1)
quad_fwd_kernel_wgmma(const float* __restrict__ x, long long xg, long long xn, long long xi,
                      const float* __restrict__ FT, long long ft_gstride,
                      float* __restrict__ out, int N, int m, int L, int per) {
  using W = Wg<NP>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const WgSmem<NP> sm = wg_setup<NP>(wg_smem);
  const int n0 = blockIdx.x * kWgRows;
  const int g = blockIdx.z;
  const int b0 = blockIdx.y * per;
  const int b1 = min(b0 + per, L);
  const int kp = (m + 7) / 8 * 8;
  const int ns = (kp + kWgSlice - 1) / kWgSlice;
  // Slice qq of this block: slice qq % ns of F_b^T, b = b0 + qq / ns.
  const int total = (b1 - b0) * ns;
  auto fill = [&](int qq) {
    if (qq >= total) return;
    if (elect_one()) {
      const uint32_t full = sm.full(qq % W::kStages);
      mbar_arrive_tx(full, NP * 128);
      bulk_copy(sm.slot(qq % W::kStages),
                FT + g * ft_gstride + ((size_t)(b0 + qq / ns) * ns + qq % ns) * W::NT * 32,
                NP * 128, full);
    }
  };
  if (warp_index() == 0)  // the first slices, while the resident tile loads
    for (int qq = 0; qq < W::kStages; ++qq) fill(qq);
  // The resident x tile through every thread's registers, rounded: consecutive
  // threads take consecutive points of one 4-deep piece (coalesced reads of
  // x given transposed) and store it in one 16-byte store; all the reads are
  // issued before any store.
  {
    const float* xb = x + g * xg;
    const int pieces = kWgRows * kp / 4;
    float v[NP / 8][4];
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int u = threadIdx.x + j * kWgBlock, r = u % kWgRows, k = u / kWgRows * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = u < pieces && n0 + r < N && k + e < m
                      ? xb[(long long)(n0 + r) * xn + (long long)(k + e) * xi]
                      : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int u = threadIdx.x + j * kWgBlock, r = u % kWgRows, k = u / kWgRows * 4;
      if (u < pieces)
        *reinterpret_cast<float4*>(sm.qf() + tile_off(r, k, kWgRows)) =
            make_float4(rna(v[j][0]), rna(v[j][1]), rna(v[j][2]), rna(v[j][3]));
    }
  }
  fence_async_smem();
  __syncthreads();
  {
    const int cw = threadIdx.x / kWgThreads;
    const int lane = threadIdx.x % 32;
    const int row = cw * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
    int q = 0;
    for (int b = b0; b < b1; ++b) {
      float t[NP / 2];
      wg_first_product<NP, NP>(sm, q, kp, cw, t, fill);
      // Rows `row` and row + 8: columns 8 j + 2 tig, + 1 (past m: zero rows of FT).
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        s0 = fmaf(t[4 * j], t[4 * j], s0);
        s0 = fmaf(t[4 * j + 1], t[4 * j + 1], s0);
        s1 = fmaf(t[4 * j + 2], t[4 * j + 2], s1);
        s1 = fmaf(t[4 * j + 3], t[4 * j + 3], s1);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (lane % 4 == 0) {
        float* o = out + ((size_t)g * L + b) * N + n0;
        if (n0 + row < N) o[row] = s0;
        if (n0 + row + 8 < N) o[row + 8] = s1;
      }
    }
  }
}

// Backward, the dx pass (DF false) or the dF pass (DF true), each two
// chained products a chunk:
//   dx:   S = x F_b[:, c]     (x resident: 128 points; chunk c: NH columns)
//         w = 2 dy[n] S,  dx += w F_b[:, c]^T
//   dF^T: S^T = F_b[:, k]^T x[c]^T  (F_b^T resident: 128 columns k; chunk c: 128 points)
//         w^T = 2 dy[c] S^T,  dF_b^T += w^T x[c]
// X, XT, FT and FN: quad_prep_kernel's tiles of x (128 points a tile, rows
// in sigma order), x^T (the same points, four 32-point slices), F_b^T (rows
// in sigma order) and F_b (per column half).
// dx: grid (ceil(N / 128), splits, G); block (tile, split, g) takes chunks
// [split per, + per) of the 2 L (channel, column half) chunks and writes
// its partial dx to out + split out_split. dF: grid (ceil(mp8 / 128), L,
// splits n_groups); block (slab, b, split n_groups + fg) takes chunks
// [split per, + per) of the factor group's (group, 128 points) chunks and
// writes its partial dF_b to out + (split n_groups + fg) out_split + b m^2.
template <bool DF, int NP>
__global__ void __launch_bounds__(kWgBlock, 1)
quad_bwd_tc_kernel_wgmma(const float* __restrict__ X, const float* __restrict__ XT,
                         const float* __restrict__ FT, const float* __restrict__ FN,
                         const float* __restrict__ dy,
                         float* __restrict__ out, long long out_split, int G, int N, int m,
                         int L, int n_groups, int per) {
  using W = Wg<NP>;
  constexpr int NC = DF ? kWgRows : W::NX;  // the chunk: t's columns
  constexpr int S = W::kStages;
  constexpr int ns2 = (NC + kWgSlice - 1) / kWgSlice;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const WgSmem<NP> sm = wg_setup<NP>(wg_smem);
  const int kp = (m + 7) / 8 * 8;
  const int ns1 = (kp + kWgSlice - 1) / kWgSlice;
  const int tiles = (N + kWgRows - 1) / kWgRows;  // x tiles a group
  const size_t xtile = (size_t)ns1 * kWgRows * kWgSlice;  // floats of one x tile
  const size_t ftile = (size_t)ns1 * W::NT * kWgSlice;    // floats of one F_b^T
  const size_t ntile = (size_t)W::kHalves * ns2 * NP * kWgSlice;  // floats of one F_b (dx)
  // This block's work. A chunk j is (channel b, column part h) for dx, and
  // (group g, x tile j % tiles) for dF.
  int g = 0, fg = 0, b = 0, n0 = 0, k0 = 0, split, j0, j1, gfirst = 0;
  if (DF) {
    k0 = blockIdx.x * kWgRows;
    b = blockIdx.y;
    fg = blockIdx.z % n_groups;
    split = blockIdx.z / n_groups;
    gfirst = n_groups == 1 ? 0 : fg;
    j0 = split * per;
    j1 = min(j0 + per, (n_groups == 1 ? G : 1) * tiles);
  } else {
    n0 = blockIdx.x * kWgRows;
    split = blockIdx.y;
    g = blockIdx.z;
    fg = n_groups == 1 ? 0 : g;
    j0 = split * per;
    j1 = min(j0 + per, W::kHalves * L);
  }
  // Slice qq of this block: chunk j0 + qq / (ns1 + ns2); within it the first
  // product's ns1 slices (depth i), then the second's ns2 (depth: the chunk).
  const int total = (j1 - j0) * (ns1 + ns2);
  auto fill = [&](int qq) {
    if (qq >= total) return;
    const int j = j0 + qq / (ns1 + ns2), r = qq % (ns1 + ns2);
    int jb = b, jg = g, h = 0, xt = 0;
    if (DF) {
      jg = gfirst + j / tiles;
      xt = j % tiles;  // the chunk's x tile
    } else {
      jb = j / W::kHalves;
      h = j % W::kHalves;  // the chunk's column part
    }
    const uint32_t slot = sm.slot(qq % S);
    const uint32_t full = sm.full(qq % S);
    const float* src;
    int bytes;
    if (r < ns1) {  // the first product: x (dF) or F_b^T at the chunk's columns (dx)
      bytes = NC * 128;
      src = DF ? X + ((size_t)jg * tiles + xt) * xtile + r * kWgRows * kWgSlice
               : FT + ((size_t)fg * L + jb) * ftile + ((size_t)r * W::NT + h * NC) * kWgSlice;
    } else {  // the second: x^T at the chunk's points (dF) or F_b at its columns (dx)
      const int s = r - ns1;
      bytes = NP * 128;
      src = DF ? XT + (((size_t)jg * tiles + xt) * ns2 + s) * NP * kWgSlice
               : FN + ((size_t)fg * L + jb) * ntile + ((size_t)h * ns2 + s) * NP * kWgSlice;
      if (s == 0) {  // 2 dy of the resident rows (dx, in sigma order) or the chunk's points (dF)
        const float* dyb = dy + ((size_t)jg * L + jb) * N;
        for (int c = threadIdx.x % 32; c < kWgRows; c += 32) {
          const int n = DF ? xt * kWgRows + c : n0 + sigma8(c);
          cp4(sm.dy(qq % S) + 4 * c, dyb + n, n < N, dy);
        }
        mbar_track_copies(full);
        __syncwarp();
      }
    }
    if (elect_one()) {
      mbar_arrive_tx(full, bytes);
      bulk_copy(slot, src, bytes, full);
    }
  };
  // The resident tile, by bulk copies: x tile (dx), or F_b^T's rows k0 ... (dF).
  if (threadIdx.x == 0) {
    const int rows = DF ? min(kWgRows, W::NT - k0) : kWgRows;
    mbar_arrive_tx(sm.qbar(), ns1 * rows * 128);
    const float* src = DF ? FT + ((size_t)fg * L + b) * ftile + (size_t)k0 * kWgSlice
                          : X + ((size_t)g * tiles + blockIdx.x) * xtile;
    const size_t stride = DF ? (size_t)W::NT * kWgSlice : (size_t)kWgRows * kWgSlice;
    for (int s = 0; s < ns1; ++s)
      bulk_copy(sm.q() + s * kWgRows * 128, src + s * stride, rows * 128, sm.qbar());
  }
  if (warp_index() == 0)  // the first slices, while the resident tile loads
    for (int qq = 0; qq < S; ++qq) fill(qq);
  mbar_wait(sm.qbar(), 0);
  {
    const int cw = threadIdx.x / kWgThreads;
    const int lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int row = cw * 64 + (threadIdx.x / 32 % 4) * 16 + gid;  // and row + 8
    float acc[NP / 2];
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) acc[e] = 0.0f;
    int q = 0;
    for (int j = j0; j < j1; ++j) {
      float t[NC / 2];
      wg_first_product<NP, NC>(sm, q, kp, cw, t, fill);
      // w = 2 dy t, rounded, in t's registers: the A operand of the second
      // product, columns 2 tig and 2 tig + 1 of each 8 as its depth tig and tig + 4.
      wg_wait_full(sm, q);
      const float* dys = sm.dyf(q % S);
#pragma unroll
      for (int jj = 0; jj < NC / 8; ++jj) {
        float d0, d1, d2, d3;  // the factors of t[4 jj + e]
        if (DF) {
          d0 = d2 = 2.0f * dys[8 * jj + tig];
          d1 = d3 = 2.0f * dys[8 * jj + tig + 4];
        } else {
          d0 = d1 = 2.0f * dys[row];
          d2 = d3 = 2.0f * dys[row + 8];
        }
        t[4 * jj] = rna(d0 * t[4 * jj]);
        t[4 * jj + 1] = rna(d1 * t[4 * jj + 1]);
        t[4 * jj + 2] = rna(d2 * t[4 * jj + 2]);
        t[4 * jj + 3] = rna(d3 * t[4 * jj + 3]);
      }
#pragma unroll
      for (int kt = 0; kt < NC / 8; ++kt) {
        const int s = kt / 4, kk = kt % 4;
        if (kk == 0) {
          if (s > 0) wg_wait_full(sm, q + s);
          wgmma_fence();
        }
        const uint32_t a[4] = {__float_as_uint(t[4 * kt]), __float_as_uint(t[4 * kt + 2]),
                               __float_as_uint(t[4 * kt + 1]), __float_as_uint(t[4 * kt + 3])};
        wgmma_rs<NP>(acc, a, smem_desc(sm.slot((q + s) % S), NP, kk));
        if (kk == 3 || kt == NC / 8 - 1) {
          wgmma_commit();
          if (s > 0) {
            wgmma_wait<1>();
            wg_release(sm, q + s - 1, fill);
          }
        }
      }
      wgmma_wait<0>();
      keep(acc);
      keep(t);
      wg_release(sm, q + ns2 - 1, fill);
      q += ns2;
    }
    // Rows row, row + 8 (positions); columns 8 jj + 2 tig, + 1 of the accumulator.
    if (DF) {
      float* o = out + (size_t)(split * n_groups + fg) * out_split + (size_t)b * m * m;
#pragma unroll
      for (int jj = 0; jj < NP / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = sigma8(k0 + row + (e >> 1) * 8);
          const int i = 8 * jj + 2 * tig + (e & 1);
          if (k < m && i < m) o[(size_t)i * m + k] = acc[4 * jj + e];
        }
    } else {
      float* o = out + (size_t)split * out_split + ((size_t)g * N + n0) * m;
#pragma unroll
      for (int jj = 0; jj < NP / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = sigma8(row) + 8 * h;
          const int i = 8 * jj + 2 * tig;
          if (n0 + n < N && i < m)
            *reinterpret_cast<float2*>(o + (size_t)n * m + i) =
                make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
    }
  }
}

// The operands of the kernels above, rounded to TF32 and laid out as the
// slots take them (tile_off), a 32-deep slice after another, zero past m
// and past the points:
//   FT: per matrix f of F, the NT x 32 tiles of F_f^T: row p = column
//       sigma8(p) of F_f, depth k of slice s = row 32 s + k;
//   FN (when not null): per matrix, per column part h, the NP x 32 tiles of
//       F_f: row i, depth k of slice s = column h NX + 32 s + k;
//   X (when not null): per group g, per 128-point tile, the 128 x 32 tiles
//       of x: row p = point 128 tile + sigma8(p), depth = i;
//   XT (with X): per group, per 128-point tile, the four NP x 32 tiles of
//       x^T: row i, depth k of slice s = point 128 tile + 32 s + k.
// One block a tile: blocks [0, nft) the FT tiles, then nfn FN tiles, then
// the X tiles, then the XT tiles. Reads go through shared memory where the
// source is not K-major (F for FT; x given transposed, as the model passes
// it, for X).
template <int NP>
__global__ void __launch_bounds__(256)
quad_prep_kernel(const float* __restrict__ F, int m, float* __restrict__ FT, int nft,
                 float* __restrict__ FN, int nfn, const float* __restrict__ x, long long xg,
                 long long xn, long long xi, int N, float* __restrict__ X, int nx,
                 float* __restrict__ XT) {
  using W = Wg<NP>;
  constexpr int kCols = W::NT > kWgRows ? W::NT : kWgRows;
  __shared__ float tile[kWgSlice][kCols + 1];
  const int kp = (m + 7) / 8 * 8;
  const int ns1 = (kp + kWgSlice - 1) / kWgSlice;
  constexpr int ns2 = (W::NX + kWgSlice - 1) / kWgSlice;
  int blk = blockIdx.x;
  if (blk < nft) {  // tile s of F_f^T: F's rows 32 s ..., every column
    const int f = blk / ns1, s = blk % ns1;
    const float* Ff = F + (size_t)f * m * m;
    for (int e = threadIdx.x; e < kWgSlice * W::NT; e += 256) {
      const int k = e / W::NT, c = e % W::NT;
      const int i = s * kWgSlice + k;
      tile[k][c] = i < m && c < m ? Ff[(size_t)i * m + c] : 0.0f;
    }
    __syncthreads();
    float* o = FT + (size_t)blk * W::NT * kWgSlice;
    for (int e = threadIdx.x; e < W::NT * kWgSlice; e += 256) {
      const int r = e / 256 * 8 + e % 256 / 32, k = (e % 32 / 4 ^ e % 256 / 32) * 4 + e % 4;
      o[e] = rna(tile[k][sigma8(r)]);
    }
    return;
  }
  blk -= nft;
  if (blk < nfn) {  // tile s of column part h of F_f
    const int f = blk / (W::kHalves * ns2), h = blk / ns2 % W::kHalves, s = blk % ns2;
    const float* Ff = F + (size_t)f * m * m;
    float* o = FN + (size_t)blk * NP * kWgSlice;
    for (int e = threadIdx.x; e < NP * kWgSlice; e += 256) {
      const int r = e / 256 * 8 + e % 256 / 32, k = (e % 32 / 4 ^ e % 256 / 32) * 4 + e % 4;
      const int c = h * W::NX + s * kWgSlice + k;
      o[e] = r < m && c < m ? rna(Ff[(size_t)r * m + c]) : 0.0f;
    }
    return;
  }
  blk -= nfn;
  const int tiles = (N + kWgRows - 1) / kWgRows;
  if (blk >= nx) {  // slice s of the x^T tile xt of group g
    blk -= nx;
    constexpr int kSlices = kWgRows / kWgSlice;
    const int g = blk / (tiles * kSlices), xt = blk / kSlices % tiles, s = blk % kSlices;
    const float* xb = x + g * xg;
    float* o = XT + (size_t)blk * NP * kWgSlice;
    for (int e = threadIdx.x; e < NP * kWgSlice; e += 256) {
      const int r = e / 256 * 8 + e % 256 / 32, k = (e % 32 / 4 ^ e % 256 / 32) * 4 + e % 4;
      const int n = xt * kWgRows + s * kWgSlice + k;
      o[e] = r < m && n < N ? rna(xb[(long long)n * xn + (long long)r * xi]) : 0.0f;
    }
    return;
  }
  // slice s of the x tile xt of group g
  const int g = blk / (tiles * ns1), xt = blk / ns1 % tiles, s = blk % ns1;
  const float* xb = x + g * xg;
  const bool along_n = xn == 1;  // read along the unit stride
  for (int e = threadIdx.x; e < kWgSlice * kWgRows; e += 256) {
    const int k = along_n ? e / kWgRows : e % kWgSlice;
    const int p = along_n ? e % kWgRows : e / kWgSlice;  // the point's offset in the tile
    const int n = xt * kWgRows + p, i = s * kWgSlice + k;
    tile[k][p] = n < N && i < m ? xb[(long long)n * xn + (long long)i * xi] : 0.0f;
  }
  __syncthreads();
  float* o = X + (size_t)blk * kWgRows * kWgSlice;
  for (int e = threadIdx.x; e < kWgRows * kWgSlice; e += 256) {
    const int r = e / 256 * 8 + e % 256 / 32, k = (e % 32 / 4 ^ e % 256 / 32) * 4 + e % 4;
    o[e] = rna(tile[k][sigma8(r)]);
  }
}

#endif  // SAT_QUAD_TF32_PASSES == 1

template <class T>
int cluster_size(int m) {
  const int tiles = (m + T::BN - 1) / T::BN;
  return tiles < kMaxCluster ? (tiles < 1 ? 1 : tiles) : kMaxCluster;
}

// Launch the forward with tile T; returns the CUDA error (0 = launched).
template <class T>
int launch_fwd(const float* x, long long x_gstride, long long xs, bool xt, const float* F,
               long long f_gstride, float* out, int G, int N, int m, int L,
               cudaStream_t stream) {
  const int nk = cluster_size<T>(m);
  const long long gx = (long long)(N + T::BM - 1) / T::BM * nk;
  if (L > 65535 || G > 65535 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte copies need x and every row of F to start on 16 bytes, and the
  // rows of x too unless it comes transposed (fwd_load shifts those).
  const bool vec4 = m % 4 == 0 && (uintptr_t)F % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                    (xt || (xs % 4 == 0 && x_gstride % 4 == 0));
  void (*kernel)(const float*, long long, long long, const float*, long long, float*, int, int,
                 int, int) = xt ? (vec4 ? quad_fwd_kernel<T, 4, true> : quad_fwd_kernel<T, 1, true>)
                                : (vec4 ? quad_fwd_kernel<T, 4, false> : quad_fwd_kernel<T, 1, false>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (unsigned)L, (unsigned)G);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, x_gstride, xs, F, f_gstride, out, N, m, L, nk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The forward's tile at these sizes: 64 x 64 up to m = 64; above, 128 x 128
// when that gives two waves of blocks (the data layer), else 64 x 128 (the
// warp layer: more blocks, each x tile read by fewer of them).
enum FwdChoice { kSmall, kMedium, kLarge };

FwdChoice fwd_choice(int G, int N, int m, int L) {
  if (m <= 64) return kSmall;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long blocks =
      (long long)(N + FwdLarge::BM - 1) / FwdLarge::BM * cluster_size<FwdLarge>(m) * L * G;
  return sms > 0 && blocks >= 2LL * sms ? kLarge : kMedium;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }


// The tensor-core backward's column tiles for m (0 above kMaxBwdM: the wide
// variant). 25 covers m = 200 exactly; 48 (m <= 384) and 64 split each row
// group's columns over two warps.
int bwd_ni(int m) {
  if (m > kMaxBwdM) return 0;
  const int c = (m + 7) / 8;
  return c <= 8 ? 8 : c <= 16 ? 16 : c <= 25 ? 25 : c <= 32 ? 32 : c <= 48 ? 48 : 64;
}

// Warps that share a row group at NI column tiles: two where one warp's
// accumulator (NI / 2 registers a lane) would not leave room for the rest.
constexpr int bwd_p(int ni) { return ni > 32 ? 2 : 1; }

// The fewest waves of blocks per unit of work: `base` blocks, each of whose
// `items` chunks may be split over up to `cap` blocks, `slots` blocks
// resident at once. A split is taken only where it saves 3 % or more.
int pick_splits(long long base, long long items, long long slots, long long cap) {
  const long long top = items < cap ? items : cap;
  int best = 1;
  double best_cost = (double)ceil_div(base, slots);
  for (long long s = 2; s <= top; ++s) {
    const double cost = (double)ceil_div(base * s, slots) / (double)s;
    if (cost < 0.97 * best_cost) {
      best = (int)s;
      best_cost = cost;
    }
  }
  // As many splits as the chunks a split takes need: none is left empty.
  const long long per = ceil_div(items, best);
  return (int)ceil_div(items, per);
}

// What the backward launches at these sizes.
struct BwdPlan {
  int ni = 0;                  // column tiles (0: the wide variant)
  int p = 1, rows = TN;        // warps a row group, rows of a block
  int stages_dx = 0, stages_df = 0;  // chunk buffers of each kernel
  int occ_dx = 0, occ_df = 0;  // blocks an SM
  int sx = 1, per_x = 0;       // dx: splits of the L * nkc chunks, chunks a split
  int sf = 1, per_f = 0;       // dF: splits of a group's rows, chunks of BC a split
  long long scratch_x = 0, scratch_f = 0;  // floats of partial sums
  // The warpgroup-MMA design (wg): its width NP (ni = NP / 8), the dx
  // pass's chunk NH, the forward's splits of the channels, and the floats
  // of the operands it prepares (after the partial sums): x's and x^T's
  // tiles, F^T's and F's.
  bool wg = false;
  int nh = 0, sw = 1, per_w = 0;
  long long prep_x = 0, prep_xt = 0, prep_ft = 0, prep_fn = 0;
  int err = 0;
};

constexpr long long kMaxPartialFloats = 1LL << 24;  // 64 MB of partial sums an output

// The scratch of the warpgroup-MMA backward, in floats: x's tiles, F^T's,
// F's, then one region that holds x^T's tiles and the dF pass's partial
// sums, and after them the dx pass's (the dF pass runs first).
long long wg_scratch(const BwdPlan& p) {
  return p.prep_x + p.prep_ft + p.prep_fn + std::max(p.prep_xt + p.scratch_f, p.scratch_x);
}


using BwdKernel = void (*)(const float*, const float*, long long, const float*, float*,
                          long long, int, int, int, int, long long, int);

template <int NI>
void plan_tc(BwdPlan& p, int G, int N, int m, int L, int n_groups) {
  constexpr int P = bwd_p(NI);
  using X = Bwd<false, NI, P>;
  using D = Bwd<true, NI, P>;
  constexpr int R = X::R;
  p.p = P;
  p.rows = R;
  p.stages_dx = X::kStages;
  p.stages_df = D::kStages;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  // Both copy widths take the same shared memory.
  const BwdKernel kernels[4] = {
      quad_bwd_tc_kernel<false, NI, P, 1>, quad_bwd_tc_kernel<false, NI, P, 4>,
      quad_bwd_tc_kernel<true, NI, P, 1>, quad_bwd_tc_kernel<true, NI, P, 4>};
  cudaError_t e = cudaSuccess;
  for (int k = 0; k < 4 && e == cudaSuccess; ++k)
    e = cudaFuncSetAttribute(kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(k < 2 ? X::kSmem : D::kSmem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.occ_dx, kernels[1], BTHREADS, X::kSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.occ_df, kernels[3], BTHREADS, D::kSmem);
  if (e != cudaSuccess || sms <= 0 || p.occ_dx < 1 || p.occ_df < 1) {
    p.err = e != cudaSuccess ? (int)e : (int)cudaErrorInvalidConfiguration;
    return;
  }
  const long long items_x = (long long)L * ceil_div(m, BC);
  const long long dx_floats = (long long)G * N * m;
  p.sx = pick_splits(ceil_div(N, R) * G, items_x, (long long)p.occ_dx * sms,
                     std::max(1LL, std::min(64LL, kMaxPartialFloats / dx_floats)));
  p.per_x = (int)ceil_div(items_x, p.sx);
  p.scratch_x = p.sx > 1 ? p.sx * dx_floats : 0;
  const long long rows_fg = (long long)G * N / n_groups;
  const long long chunks = ceil_div(rows_fg, BC);
  const long long df_floats = (long long)n_groups * L * m * m;
  p.sf = pick_splits(ceil_div(m, R) * L * n_groups, chunks, (long long)p.occ_df * sms,
                     std::max(1LL, std::min(64LL, kMaxPartialFloats / df_floats)));
  p.per_f = (int)ceil_div(chunks, p.sf);
  p.scratch_f = p.sf > 1 ? p.sf * df_floats : 0;
}

// How many row ranges the wide variant's dF pass splits each factor group
// into: enough blocks for about two per SM, never more than the group has
// row tiles.
int wide_splits(int G, int N, int m, int L, int n_groups) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (sms < 0) return -1;
  const long long rows_fg = (long long)G * N / n_groups;
  const long long blocks = ceil_div(m, TK) * L * n_groups;
  long long s = (2LL * sms) / blocks;
  s = s < 1 ? 1 : s;
  const long long tiles = ceil_div(rows_fg, TN);
  return (int)(s < tiles ? s : tiles);
}

// ---- Host side of the warpgroup-MMA design. ----

// The one-pass build takes it where a 64 x m accumulator fits a warpgroup
// and rows of m floats are whole 16-byte pieces.
bool wg_path(int m) { return kOnePass && m >= 1 && m <= kWgMaxM && m % 4 == 0; }

int wg_np(int m) { return m <= 64 ? 64 : m <= 128 ? 128 : m <= 200 ? 200 : 256; }

#if SAT_QUAD_TF32_PASSES == 1

// Shared memory for the three kernels of width NP; the blocks an SM they get.
template <int NP>
int wg_attrs(int& occ) {
  const void* kernels[3] = {(const void*)quad_fwd_kernel_wgmma<NP>,
                            (const void*)quad_bwd_tc_kernel_wgmma<false, NP>,
                            (const void*)quad_bwd_tc_kernel_wgmma<true, NP>};
  occ = 1 << 30;
  for (const void* k : kernels) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Wg<NP>::kSmem);
    int o = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, k, kWgBlock, Wg<NP>::kSmem);
    if (e != cudaSuccess) return (int)e;
    occ = std::min(occ, o);
  }
  return occ >= 1 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <int NP>
void plan_wg(BwdPlan& p, int G, int N, int m, int L, int n_groups) {
  p.wg = true;
  p.ni = NP / 8;
  p.rows = kWgRows;
  p.nh = Wg<NP>::NX;
  p.stages_dx = p.stages_df = Wg<NP>::kStages;
  p.err = wg_attrs<NP>(p.occ_dx);
  p.occ_df = p.occ_dx;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (p.err == 0 && sms <= 0) p.err = (int)cudaErrorInvalidDevice;
  if (p.err != 0) return;
  const long long slots = (long long)p.occ_dx * sms;
  const long long tiles = ceil_div(N, kWgRows) * G;
  p.sw = pick_splits(tiles, L, slots, L);
  p.per_w = (int)ceil_div(L, p.sw);
  const long long dx_floats = (long long)G * N * m;
  const long long items_x = (long long)Wg<NP>::kHalves * L;
  p.sx = pick_splits(tiles, items_x, slots,
                     std::max(1LL, std::min(64LL, kMaxPartialFloats / dx_floats)));
  p.per_x = (int)ceil_div(items_x, p.sx);
  p.scratch_x = p.sx > 1 ? p.sx * dx_floats : 0;
  const int kp = (m + 7) / 8 * 8;
  const long long chunks = (n_groups == 1 ? G : 1) * ceil_div(N, kWgRows);
  const long long df_floats = (long long)n_groups * L * m * m;
  p.sf = pick_splits(ceil_div(kp, kWgRows) * L * n_groups, chunks, slots,
                     std::max(1LL, std::min(64LL, kMaxPartialFloats / df_floats)));
  p.per_f = (int)ceil_div(chunks, p.sf);
  p.scratch_f = p.sf > 1 ? p.sf * df_floats : 0;
  const long long ns1 = ceil_div(kp, kWgSlice), ns2 = ceil_div(Wg<NP>::NX, kWgSlice);
  p.prep_x = G * ceil_div(N, kWgRows) * ns1 * kWgRows * kWgSlice;
  p.prep_xt = G * ceil_div(N, kWgRows) * kWgRows * NP;
  p.prep_ft = n_groups * L * ns1 * Wg<NP>::NT * kWgSlice;
  p.prep_fn = n_groups * L * Wg<NP>::kHalves * ns2 * NP * kWgSlice;
}

#endif  // SAT_QUAD_TF32_PASSES == 1

BwdPlan bwd_plan(int G, int N, int m, int L, int n_groups) {
  BwdPlan p;
#if SAT_QUAD_TF32_PASSES == 1
  if (wg_path(m)) {
    switch (wg_np(m)) {
      case 64: plan_wg<64>(p, G, N, m, L, n_groups); break;
      case 128: plan_wg<128>(p, G, N, m, L, n_groups); break;
      case 200: plan_wg<200>(p, G, N, m, L, n_groups); break;
      default: plan_wg<256>(p, G, N, m, L, n_groups);
    }
    return p;
  }
#endif
  p.ni = bwd_ni(m);
  switch (p.ni) {
    case 8: plan_tc<8>(p, G, N, m, L, n_groups); break;
    case 16: plan_tc<16>(p, G, N, m, L, n_groups); break;
    case 25: plan_tc<25>(p, G, N, m, L, n_groups); break;
    case 32: plan_tc<32>(p, G, N, m, L, n_groups); break;
    case 48: plan_tc<48>(p, G, N, m, L, n_groups); break;
    case 64: plan_tc<64>(p, G, N, m, L, n_groups); break;
    default: {
      const int s = wide_splits(G, N, m, L, n_groups);
      if (s < 1) {
        p.err = (int)cudaErrorInvalidDevice;
        break;
      }
      p.sf = s;
      p.scratch_f = (long long)s * n_groups * L * m * m;
    }
  }
  return p;
}

int launch_sum(const float* partial, float* out, long long total, int splits, cudaStream_t s) {
  const long long nb = ceil_div(total, kThreads);
  quad_sum_kernel<<<(unsigned)(nb < 4096 ? nb : 4096), kThreads, 0, s>>>(partial, out, total,
                                                                          splits);
  return (int)cudaGetLastError();
}

template <int NI>
int launch_bwd_tc(const BwdPlan& p, const float* x, const float* F, long long f_gstride,
                  const float* dy, float* dx, float* dF, float* scratch, int G, int N, int m,
                  int L, int n_groups, cudaStream_t s) {
  const long long dx_floats = (long long)G * N * m;
  const long long df_floats = (long long)n_groups * L * m * m;
  float* px = p.sx > 1 ? scratch : dx;
  float* pf = p.sf > 1 ? scratch + p.scratch_x : dF;
  // 16-byte copies where every row of x and F starts on 16 bytes.
  const bool vec4 = m % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)F % 16 == 0;
  constexpr int P = bwd_p(NI);
  using X = Bwd<false, NI, P>;
  using D = Bwd<true, NI, P>;
  const BwdKernel kx =
      vec4 ? quad_bwd_tc_kernel<false, NI, P, 4> : quad_bwd_tc_kernel<false, NI, P, 1>;
  const BwdKernel kf =
      vec4 ? quad_bwd_tc_kernel<true, NI, P, 4> : quad_bwd_tc_kernel<true, NI, P, 1>;
  dim3 gx((unsigned)ceil_div(N, X::R), (unsigned)p.sx, (unsigned)G);
  kx<<<gx, BTHREADS, X::kSmem, s>>>(x, F, f_gstride, dy, px, dx_floats, N, m, L, n_groups, 0,
                                    p.per_x);
  int e = (int)cudaGetLastError();
  if (e == 0 && p.sx > 1) e = launch_sum(px, dx, dx_floats, p.sx, s);
  if (e != 0) return e;
  dim3 gf((unsigned)ceil_div(m, D::R), (unsigned)L, (unsigned)(p.sf * n_groups));
  kf<<<gf, BTHREADS, D::kSmem, s>>>(x, F, f_gstride, dy, pf, (long long)L * m * m, N, m, L,
                                    n_groups, (long long)G * N / n_groups, p.per_f);
  e = (int)cudaGetLastError();
  if (e == 0 && p.sf > 1) e = launch_sum(pf, dF, df_floats, p.sf, s);
  return e;
}

#if SAT_QUAD_TF32_PASSES == 1
// The operands of the warpgroup-MMA kernels (quad_prep_kernel): F^T's tiles
// from the nmat matrices of F, and F's, x's and x^T's where FN and X are not
// null (XT with X).
template <int NP>
int launch_prep(const float* F, int nmat, int m, float* FT, float* FN, const float* x,
                long long xg, long long xn, long long xi, int G, int N, float* X, float* XT,
                cudaStream_t s) {
  const long long ns1 = ceil_div((m + 7) / 8 * 8, kWgSlice);
  const long long nft = nmat * ns1;
  const long long nfn =
      FN != nullptr ? nmat * Wg<NP>::kHalves * ceil_div(Wg<NP>::NX, kWgSlice) : 0;
  const long long tiles = ceil_div(N, kWgRows);
  const long long nx = X != nullptr ? G * tiles * ns1 : 0;
  const long long nxt = X != nullptr ? G * tiles * (kWgRows / kWgSlice) : 0;
  if (nft + nfn + nx + nxt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quad_prep_kernel<NP><<<(unsigned)(nft + nfn + nx + nxt), 256, 0, s>>>(
      F, m, FT, (int)nft, FN, (int)nfn, x, xg, xn, xi, N, X, (int)nx, XT);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_fwd_wg(const BwdPlan& p, const float* x, long long xg, long long xn, long long xi,
                  const float* F, bool per_group, float* out, float* FT, int G, int N, int m,
                  int L, cudaStream_t s) {
  int e = launch_prep<NP>(F, (per_group ? G : 1) * L, m, FT, nullptr, nullptr, 0, 0, 0, 0, 0,
                          nullptr, nullptr, s);
  if (e != 0) return e;
  const dim3 grid((unsigned)ceil_div(N, kWgRows), (unsigned)p.sw, (unsigned)G);
  quad_fwd_kernel_wgmma<NP><<<grid, kWgBlock, Wg<NP>::kSmem, s>>>(
      x, xg, xn, xi, FT, per_group ? p.prep_ft / G : 0, out, N, m, L, p.per_w);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_bwd_wg(const BwdPlan& p, const float* x, long long xg, long long xn, long long xi,
                  const float* F, const float* dy, float* dx, float* dF, float* scratch, int G,
                  int N, int m, int L, int n_groups, cudaStream_t s) {
  const long long dx_floats = (long long)G * N * m;
  const long long df_floats = (long long)n_groups * L * m * m;
  float* X = scratch;
  float* FT = X + p.prep_x;
  float* FN = FT + p.prep_ft;
  float* XT = FN + p.prep_fn;
  float* pf = p.sf > 1 ? XT + p.prep_xt : dF;
  float* px = p.sx > 1 ? XT : dx;  // over x^T's tiles and dF's partial sums, dead by then
  int e = launch_prep<NP>(F, n_groups * L, m, FT, FN, x, xg, xn, xi, G, N, X, XT, s);
  if (e != 0) return e;
  quad_bwd_tc_kernel_wgmma<true, NP>
      <<<dim3((unsigned)ceil_div((m + 7) / 8 * 8, kWgRows), (unsigned)L,
              (unsigned)(p.sf * n_groups)),
         kWgBlock, Wg<NP>::kSmem, s>>>(X, XT, FT, FN, dy, pf, (long long)L * m * m, G, N, m,
                                        L, n_groups, p.per_f);
  e = (int)cudaGetLastError();
  if (e == 0 && p.sf > 1) e = launch_sum(pf, dF, df_floats, p.sf, s);
  if (e != 0) return e;
  quad_bwd_tc_kernel_wgmma<false, NP>
      <<<dim3((unsigned)ceil_div(N, kWgRows), (unsigned)p.sx, (unsigned)G), kWgBlock,
         Wg<NP>::kSmem, s>>>(X, XT, FT, FN, dy, px, dx_floats, G, N, m, L, n_groups, p.per_x);
  e = (int)cudaGetLastError();
  if (e == 0 && p.sx > 1) e = launch_sum(px, dx, dx_floats, p.sx, s);
  return e;
}

#endif  // SAT_QUAD_TF32_PASSES == 1

int launch_bwd_wide(const BwdPlan& p, const float* x, const float* F, long long f_gstride,
                    const float* dy, float* dx, float* dF, float* partial, int G, int N, int m,
                    int L, int n_groups, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      quad_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDxSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(quad_df_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDfSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 gdx((unsigned)ceil_div(N, TN), (unsigned)G);
  quad_dx_kernel<<<gdx, kThreads, kDxSmem, s>>>(x, F, f_gstride, dy, dx, N, m, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows_fg = (long long)G * N / n_groups;
  const long long per_split = ceil_div(ceil_div(rows_fg, TN), p.sf) * TN;
  dim3 gdf((unsigned)ceil_div(m, TK), (unsigned)L, (unsigned)(p.sf * n_groups));
  quad_df_kernel<<<gdf, kThreads, kDfSmem, s>>>(x, F, f_gstride, dy, partial, N, m, L,
                                                n_groups, rows_fg, per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum(partial, dF, (long long)n_groups * L * m * m, p.sf, s);
}

}  // namespace

extern "C" {

// TF32 passes a product of this build (3, or 1 for "default").
int sat_quad_tf32_passes() { return SAT_QUAD_TF32_PASSES; }

// The forward's design at these sizes: the rows and the columns of t in
// its block tile, and the blocks of its cluster (splits of the columns;
// 1 in the warpgroup-MMA design, which keeps whole rows of t).
int sat_quad_fwd_tile_rows(int G, int N, int m, int L) {
  if (wg_path(m)) return kWgRows;
  const FwdChoice c = fwd_choice(G, N, m, L);
  return c == kLarge ? FwdLarge::BM : c == kMedium ? FwdMedium::BM : FwdSmall::BM;
}

int sat_quad_fwd_tile_cols(int G, int N, int m, int L) {
  if (wg_path(m)) return wg_np(m);
  const FwdChoice c = fwd_choice(G, N, m, L);
  return c == kLarge ? FwdLarge::BN : c == kMedium ? FwdMedium::BN : FwdSmall::BN;
}

int sat_quad_fwd_cluster(int G, int N, int m, int L) {
  if (wg_path(m)) return 1;
  const FwdChoice c = fwd_choice(G, N, m, L);
  return c == kLarge    ? cluster_size<FwdLarge>(m)
         : c == kMedium ? cluster_size<FwdMedium>(m)
                        : cluster_size<FwdSmall>(m);
}

// Floats of scratch the forward needs at these sizes (F_b^T rounded, for
// the warpgroup-MMA design; 0 otherwise).
long long sat_quad_fwd_scratch_floats(int G, int N, int m, int L, int per_group) {
  if (!wg_path(m)) return 0;
  const long long ns1 = ceil_div((m + 7) / 8 * 8, kWgSlice);
  const int nh = (wg_np(m) / 2 + 7) / 8 * 8;
  return (long long)(per_group ? G : 1) * L * ns1 * 2 * nh * kWgSlice;
}

// x (G, N, m), point n, depth i of group g at x[g * x_gstride + n * x_nstride
// + i * x_istride]; F (L, m, m) when f_gstride is 0, else (G, L, m, m) with
// f_gstride = L * m * m, contiguous; out (G, L, N) contiguous; `scratch`
// the floats sat_quad_fwd_scratch_floats reports (may be null when 0). All
// float32 on the device. The warpgroup-MMA design reads x at any strides;
// the others take x_istride == 1 (rows) or x_nstride == 1 (x given
// transposed, as the model passes it). Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
int sat_quad_fwd_strided_f32(const void* x, long long x_gstride, long long x_nstride,
                             long long x_istride, const void* F, long long f_gstride, void* out,
                             void* scratch, int G, int N, int m, int L, void* stream) {
  if (G <= 0 || N <= 0 || m <= 0 || L <= 0) return 0;
  const float* xf = (const float*)x;
  const float* Ff = (const float*)F;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#if SAT_QUAD_TF32_PASSES == 1
  {
    if (wg_path(m)) {
      if (L > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
      const BwdPlan p = bwd_plan(G, N, m, L, f_gstride != 0 ? G : 1);
      if (p.err != 0) return p.err;
      float* FT = (float*)scratch;
      switch (wg_np(m)) {
        case 64: return launch_fwd_wg<64>(p, xf, x_gstride, x_nstride, x_istride, Ff, f_gstride != 0, o, FT, G, N, m, L, s);
        case 128: return launch_fwd_wg<128>(p, xf, x_gstride, x_nstride, x_istride, Ff, f_gstride != 0, o, FT, G, N, m, L, s);
        case 200: return launch_fwd_wg<200>(p, xf, x_gstride, x_nstride, x_istride, Ff, f_gstride != 0, o, FT, G, N, m, L, s);
        default: return launch_fwd_wg<256>(p, xf, x_gstride, x_nstride, x_istride, Ff, f_gstride != 0, o, FT, G, N, m, L, s);
      }
    }
  }
#endif
  const bool xt = x_istride != 1;
  if (xt && x_nstride != 1) return (int)cudaErrorInvalidValue;
  const long long xs = xt ? x_istride : x_nstride;
  switch (fwd_choice(G, N, m, L)) {
    case kLarge: return launch_fwd<FwdLarge>(xf, x_gstride, xs, xt, Ff, f_gstride, o, G, N, m, L, s);
    case kMedium:
      return launch_fwd<FwdMedium>(xf, x_gstride, xs, xt, Ff, f_gstride, o, G, N, m, L, s);
    default: return launch_fwd<FwdSmall>(xf, x_gstride, xs, xt, Ff, f_gstride, o, G, N, m, L, s);
  }
}

// The backward's design at these sizes, into out[12]: column tiles of the
// tensor-core kernels (0: the wide variant), rows of a block, chunk depth,
// blocks an SM of the dx and the dF kernel, splits of dx's chunks and of
// dF's rows (each > 1 adds a fixed-order sum), the floats of scratch the
// backward needs, the warps that share a row group, the chunk buffers of
// the dx and the dF kernel, and 1 for the warpgroup-MMA design (0 for the
// mma.sync ones). Returns 0, or the CUDA error of the queries.
int sat_quad_bwd_design(int G, int N, int m, int L, int n_groups, long long* out) {
  const BwdPlan p = bwd_plan(G, N, m, L, n_groups);
  if (p.err != 0) return p.err;
  const long long scratch = p.wg ? wg_scratch(p) : p.scratch_x + p.scratch_f;
  const long long v[12] = {p.ni, p.ni ? p.rows : TN, p.wg ? p.nh : p.ni ? BC : TK, p.occ_dx,
                           p.occ_df, p.sx, p.sf, scratch, p.p,
                           p.stages_dx, p.stages_df, p.wg ? 1 : 0};
  for (int k = 0; k < 12; ++k) out[k] = v[k];
  return 0;
}

// The backward: dy (G, L, N) in, dx (G, N, m) and dF (F's shape) out
// (contiguous), x and F as for the forward. The mma.sync designs take x
// contiguous; the warpgroup-MMA design reads it at any strides. `scratch`
// holds the floats sat_quad_bwd_design reports for the same sizes (may be
// null when that is 0). Two to five launches on `stream`; returns the first
// launch error (0 = all launched).
int sat_quad_bwd_strided_f32(const void* x, long long x_gstride, long long x_nstride,
                             long long x_istride, const void* F, long long f_gstride,
                             const void* dy, void* dx, void* dF, void* scratch, int G, int N,
                             int m, int L, int n_groups, void* stream) {
  if (G <= 0 || N <= 0 || m <= 0 || L <= 0) return 0;
  if (L > 65535 || G > 65535 || n_groups < 1 || G % n_groups != 0)
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(G, N, m, L, n_groups);
  if (p.err != 0) return p.err;
  if ((long long)p.sf * n_groups > 65535) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* Ff = (const float*)F;
  const float* dyf = (const float*)dy;
  float* dxf = (float*)dx;
  float* dFf = (float*)dF;
  float* sc = (float*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
#if SAT_QUAD_TF32_PASSES == 1
  {
    if (p.wg) {
      switch (wg_np(m)) {
        case 64: return launch_bwd_wg<64>(p, xf, x_gstride, x_nstride, x_istride, Ff, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
        case 128: return launch_bwd_wg<128>(p, xf, x_gstride, x_nstride, x_istride, Ff, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
        case 200: return launch_bwd_wg<200>(p, xf, x_gstride, x_nstride, x_istride, Ff, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
        default: return launch_bwd_wg<256>(p, xf, x_gstride, x_nstride, x_istride, Ff, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
      }
    }
  }
#endif
  if (x_istride != 1 || x_nstride != m || (G > 1 && x_gstride != (long long)N * m))
    return (int)cudaErrorInvalidValue;
  switch (p.ni) {
    case 8: return launch_bwd_tc<8>(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
    case 16: return launch_bwd_tc<16>(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
    case 25: return launch_bwd_tc<25>(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
    case 32: return launch_bwd_tc<32>(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
    case 48: return launch_bwd_tc<48>(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
    case 64: return launch_bwd_tc<64>(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
    default: return launch_bwd_wide(p, xf, Ff, f_gstride, dyf, dxf, dFf, sc, G, N, m, L, n_groups, s);
  }
}

// The same for a contiguous x (G, N, m).
int sat_quad_bwd_f32(const void* x, const void* F, long long f_gstride, const void* dy,
                     void* dx, void* dF, void* scratch, int G, int N, int m, int L,
                     int n_groups, void* stream) {
  return sat_quad_bwd_strided_f32(x, (long long)N * m, m, 1, F, f_gstride, dy, dx, dF, scratch,
                                  G, N, m, L, n_groups, stream);
}

}  // extern "C"
