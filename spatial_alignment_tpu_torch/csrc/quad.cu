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
// The backward keeps the first design: every kernel builds 64 x 64 tiles
// of t the same way (t_tile), 256 threads, each holding a 4 x 4 register
// tile on the plain fp32 pipes; x and F are staged through shared memory
// 16 deep. Ragged edges are zero-filled, which is exact.
//   quad_dx_kernel    grid (N/64, G): the block owns dx for its points over
//                     256 columns at a time (64 accumulators a thread) and
//                     loops over channels and k-tiles: t tile, w = 2 dy t to
//                     shared memory, dx += w F_b[:, k-tile]^T.
//   quad_df_kernel    grid (m/64, L, splits x factor groups): the block owns
//                     a 256 x 64 block of dF_b (64 accumulators a thread)
//                     for one contiguous range of rows, and for each 64 rows
//                     makes the t tile, w, and adds x^T w. Blocks run in no
//                     order, so each writes its partial sum, and
//   quad_sum_kernel   adds the splits' partial sums in a fixed order. The
//                     result does not depend on the schedule.
// m above 256 loops over 256-column passes, making t again in each.
//
// What bounds the backward: operations. It makes t twice and does two more
// products of the size of the forward's, on the plain fp32 pipes.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace {

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
// hi hi), issued pass by pass so that consecutive mma of a warp never wait
// on each other; the next step's fragments are read from shared memory
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
      for (int e = 0; e < 4; ++e) split_tf32(ra[mt][e], ahi[mt][e], alo[mt][e]);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) split_tf32(rb[nt][e], bhi[nt][e], blo[nt][e]);
    if (kk + 8 < FK)
      fwd_frags<T, XT>(st, kk + 8, wm, wn, gid, tig, shift(kk + 8 + tig), shift(kk + 12 + tig),
                       ra, rb);
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

}  // namespace

extern "C" {

// The forward's design at these sizes: the rows and the columns of t in
// its block tile, and the blocks of its cluster (splits of the columns).
int sat_quad_fwd_tile_rows(int G, int N, int m, int L) {
  const FwdChoice c = fwd_choice(G, N, m, L);
  return c == kLarge ? FwdLarge::BM : c == kMedium ? FwdMedium::BM : FwdSmall::BM;
}

int sat_quad_fwd_tile_cols(int G, int N, int m, int L) {
  const FwdChoice c = fwd_choice(G, N, m, L);
  return c == kLarge ? FwdLarge::BN : c == kMedium ? FwdMedium::BN : FwdSmall::BN;
}

int sat_quad_fwd_cluster(int G, int N, int m, int L) {
  const FwdChoice c = fwd_choice(G, N, m, L);
  return c == kLarge    ? cluster_size<FwdLarge>(m)
         : c == kMedium ? cluster_size<FwdMedium>(m)
                        : cluster_size<FwdSmall>(m);
}

// How many row ranges the dF pass splits each factor group into: enough
// blocks for about two per SM, never more than the group has row tiles.
// `n_groups` is 1 for shared factors and G for one set per group.
int sat_quad_bwd_splits(int G, int N, int m, int L, int n_groups) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (sms < 0) return -1;
  const long long rows_fg = (long long)G * N / n_groups;
  const long long blocks = ceil_div(m, TK) * L * n_groups;
  long long s = (2LL * sms) / blocks;
  s = s < 1 ? 1 : s;
  const long long tiles = ceil_div(rows_fg, TN);
  return (int)(s < tiles ? s : tiles);
}

// x (G, N, m), point n, depth i of group g at x[g * x_gstride + n * x_nstride
// + i * x_istride] with x_istride == 1 (rows) or x_nstride == 1 (x given
// transposed, as the model passes it); F (L, m, m) when f_gstride is 0,
// else (G, L, m, m) with f_gstride = L * m * m, contiguous; out (G, L, N)
// contiguous. All float32 on the device. Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
int sat_quad_fwd_strided_f32(const void* x, long long x_gstride, long long x_nstride,
                             long long x_istride, const void* F, long long f_gstride, void* out,
                             int G, int N, int m, int L, void* stream) {
  if (G <= 0 || N <= 0 || m <= 0 || L <= 0) return 0;
  const bool xt = x_istride != 1;
  if (xt && x_nstride != 1) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* Ff = (const float*)F;
  const long long xs = xt ? x_istride : x_nstride;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fwd_choice(G, N, m, L)) {
    case kLarge: return launch_fwd<FwdLarge>(xf, x_gstride, xs, xt, Ff, f_gstride, o, G, N, m, L, s);
    case kMedium:
      return launch_fwd<FwdMedium>(xf, x_gstride, xs, xt, Ff, f_gstride, o, G, N, m, L, s);
    default: return launch_fwd<FwdSmall>(xf, x_gstride, xs, xt, Ff, f_gstride, o, G, N, m, L, s);
  }
}

// The same for a contiguous x (G, N, m).
int sat_quad_fwd_f32(const void* x, const void* F, long long f_gstride, void* out,
                     int G, int N, int m, int L, void* stream) {
  return sat_quad_fwd_strided_f32(x, (long long)N * m, m, 1, F, f_gstride, out, G, N, m, L,
                                  stream);
}

// The backward: dy (G, L, N) in, dx (G, N, m) and dF (F's shape) out.
// `partial` is scratch of splits * n_groups * L * m * m floats, `splits`
// from sat_quad_bwd_splits. Three launches on `stream` (dx, dF partial sums,
// their sum); returns the first launch error (0 = all launched).
int sat_quad_bwd_f32(const void* x, const void* F, long long f_gstride, const void* dy,
                     void* dx, void* dF, void* partial, int G, int N, int m, int L,
                     int n_groups, int splits, void* stream) {
  if (G <= 0 || N <= 0 || m <= 0 || L <= 0) return 0;
  if (L > 65535 || G > 65535 || splits < 1 || n_groups < 1 ||
      (long long)splits * n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      quad_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDxSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(quad_df_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDfSmem);
  if (e != cudaSuccess) return (int)e;
  const float* xf = (const float*)x;
  const float* Ff = (const float*)F;
  const float* dyf = (const float*)dy;
  dim3 gdx((unsigned)ceil_div(N, TN), (unsigned)G);
  quad_dx_kernel<<<gdx, kThreads, kDxSmem, s>>>(xf, Ff, f_gstride, dyf, (float*)dx, N, m, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows_fg = (long long)G * N / n_groups;
  const long long per_split = ceil_div(ceil_div(rows_fg, TN), splits) * TN;
  dim3 gdf((unsigned)ceil_div(m, TK), (unsigned)L, (unsigned)(splits * n_groups));
  quad_df_kernel<<<gdf, kThreads, kDfSmem, s>>>(xf, Ff, f_gstride, dyf, (float*)partial, N,
                                                m, L, n_groups, rows_fg, per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)n_groups * L * m * m;
  const long long nb = ceil_div(total, kThreads);
  quad_sum_kernel<<<(unsigned)(nb < 4096 ? nb : 4096), kThreads, 0, s>>>(
      (const float*)partial, (float*)dF, total, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
