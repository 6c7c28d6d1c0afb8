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
// Design. Every kernel builds 64 x 64 tiles of t the same way (t_tile):
// 256 threads, each holding a 4 x 4 register tile; x and F are staged
// through shared memory 16 deep. Ragged edges are zero-filled, which is
// exact: zero rows of x and zero columns of F add nothing to t, t^2, dx or
// dF.
//   quad_fwd_kernel   grid (N/64, L, G): one tile of points and one channel
//                     loop over all k-tiles, square and sum in registers,
//                     then sum across the 16 threads of a row by shuffles.
//                     No atomics, one write per output.
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
// What bounds it on the card: operations. At the data layer of the
// m = 200 fit the forward is 2 G N L m^2 = 1.6e10 fp32 operations, 0.24 ms
// at 67 TFLOP/s, against 16 MB of x to read; the backward makes t twice
// and does two more products of the same size. This first design uses the
// plain fp32 pipes through register tiles, not the tensor cores.

#include "common.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads)
quad_fwd_kernel(const float* __restrict__ x, const float* __restrict__ F,
                long long f_gstride, float* __restrict__ out, int N, int m, int L) {
  __shared__ float tile[kTileFloats];
  const int n0 = blockIdx.x * TN;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nrows = min(TN, N - n0);
  const float* xg = x + ((size_t)g * N + n0) * m;
  const float* Fb = F + g * f_gstride + (size_t)b * m * m;
  float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < m; k0 += TK) {
    float acc[4][4];
    t_tile(xg, nrows, m, Fb, k0, acc, tile, tile + TI * XS);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sq[r] = fmaf(acc[r][c], acc[r][c], sq[r]);
  }
  // The 16 threads of a row are 16 consecutive lanes of one warp.
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 8; off > 0; off /= 2) sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], off);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = ty + 16 * r;
      if (n < nrows) out[((size_t)g * L + b) * N + n0 + n] = sq[r];
    }
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

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

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

// x (G, N, m); F (L, m, m) when f_gstride is 0, else (G, L, m, m) with
// f_gstride = L * m * m; out (G, L, N). All contiguous float32 on the
// device. Launches on `stream`; returns cudaGetLastError() (0 = launched).
int sat_quad_fwd_f32(const void* x, const void* F, long long f_gstride, void* out,
                     int G, int N, int m, int L, void* stream) {
  if (G <= 0 || N <= 0 || m <= 0 || L <= 0) return 0;
  if (L > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ceil_div(N, TN), (unsigned)L, (unsigned)G);
  quad_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)F, f_gstride, (float*)out, N, m, L);
  return (int)cudaGetLastError();
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
