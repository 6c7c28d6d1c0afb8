// Cross-Gram K[g][i][j] = exp(log_var) k(|x1_i - x2_j|; exp(log_ls)) in
// float32, for Hopper, for the stationary kernels rbf, matern12 (the
// reference's exp(-0.5 d / l) form) and matern32.
//
// Replaces the TPU kernel spatial_alignment_tpu/ops/pallas_gram.py:pallas_gram
// (body _gram_kernel_body, launched by _pallas_gram_2d and vmapped over x2's
// batch dims). The JAX package reaches it only under set_gram_force(True) or
// gram(..., force=True); the port does the same (ops/gram.py).
//
// Batch layout: G groups. x1 is (M, D) shared by every group (stride 0) or
// (G, M, D); x2 is (N, D) shared or (G, N, D); log_ls and log_var are one
// value (stride 0) or one per group (stride 1), on the device. That covers
// the data layer (x1 shared, x2 (S, N, D), scalar parameters), the warp layer
// (x1 (Va, M, D), x2 (Va, N, D), per-view parameters) and the plain 2-D case
// in one kernel. D <= 8, as the TPU kernel's one padded sublane tile.
//
// Arithmetic, as _gram_kernel_body: squared distance by direct differences
// summed over d in order (rounded multiply, rounded add: no fused
// multiply-add, so the sum is the plain version's), then full-precision
// expf / sqrtf. The output store is float32, or bfloat16 (round to nearest
// even) for the TPU kernel's out_dtype=bf16; all arithmetic stays float32.
//
// What bounds it on the card: the output. Per element it reads nothing new
// (x1 from shared memory, x2 from registers) and does about 3D + 8 float
// operations (one or two of them transcendental), against 4 bytes written:
// at the data layer's (5, 100, 8192) that is 16.4 MB, about 4.9 us at
// 3.35 TB/s, with ~5.7e7 operations, under 1 us at 67 TFLOP/s.
//
// Design: a block of 128 threads owns 512 consecutive columns j of one group
// and an even share of the rows i: the M rows are cut into `splits` ranges
// whose sizes differ by at most one (split s takes rows [s M / splits,
// (s + 1) M / splits)), staged in shared memory. Each thread keeps the x2 of
// its 4 columns in registers and, row by row (two rows an iteration), makes 4
// values and stores them. Where N is a multiple of 4 and the output is
// aligned, its columns are consecutive and go out in one 16-byte store
// (8 bytes for bfloat16): a warp's store of a row is 512 contiguous bytes.
// Otherwise (the scalar edge) its columns are 128 apart and each goes out
// alone, a warp's store then covering 128 contiguous bytes. The host picks
// `splits`: at most 8 rows a block, fewer where that leaves fewer than two
// blocks a streaming multiprocessor. D = 2, the coordinates of every path,
// is compiled apart: a loop over up to 8 coordinates, predicated on D,
// costs more instructions an element than the distance itself. The x2
// values are asked for before the rows are staged, so that the two loads'
// latencies overlap.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, tools/
// kernel_probe.py, chip_smoke.py): 0.0075 ms at the data layer's (5, 100,
// 8192), 66 % of its bytes bound, against the first design's 0.0123 (one
// thread a column, 32 rows a block, the rows cut 32, 32, 32, 4); a
// launch of an empty kernel takes 0.0019 there. 256 or 64 threads a block
// and streaming (evict-first) stores were no faster.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                    // columns a thread
constexpr int kTile = kThreads * kCols;     // columns a block
constexpr int kRows = 8;                    // rows of x1 a block at most
constexpr int kMaxDim = 8;                  // D <= 8
constexpr int kBlocksPerSm = 2;             // blocks the grid has at least, per SM

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2 };

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The 4 values of consecutive columns at p, in one store (p aligned).
__device__ __forceinline__ void store4(float* p, const float (&v)[kCols]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kCols]) {
  __nv_bfloat162 a = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  __nv_bfloat162 b = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<unsigned*>(&a), *reinterpret_cast<unsigned*>(&b));
}

// One element from its squared distance, in _gram_kernel_body's order.
template <int KIND>
__device__ __forceinline__ float gram_value(float acc, float var, float inv_ls, float inv_ls2) {
  float v;
  if (KIND == kRbf) {
    v = var * expf(-0.5f * acc * inv_ls2);
  } else if (KIND == kMatern12) {
    const float dist = sqrtf(acc + 1e-10f);
    v = var * expf(-0.5f * dist * inv_ls);
  } else {
    const float dist = sqrtf(acc + 1e-10f);
    const float inner = 1.7320508075688772f * dist * inv_ls;
    v = var * (1.0f + inner) * expf(-inner);
  }
  return v;
}

// grid (ceil(N / kTile), G, splits). DIM: D fixed at compile time (2, the
// coordinates of every path), or 0 for any D <= kMaxDim.
template <int KIND, typename OutT, bool VEC, int DIM>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x1, long long x1_stride,
            const float* __restrict__ x2, long long x2_stride,
            const float* __restrict__ log_ls, int ls_stride,
            const float* __restrict__ log_var, int var_stride,
            OutT* __restrict__ out, int M, int N, int D_) {
  constexpr int kDims = DIM ? DIM : kMaxDim;  // unrolled steps over d
  const int D = DIM ? DIM : D_;
  __shared__ float rows_x1[kRows * kMaxDim];
  const long long g = blockIdx.y;
  const int i0 = (int)((long long)blockIdx.z * M / gridDim.z);
  const int rows = (int)((long long)(blockIdx.z + 1) * M / gridDim.z) - i0;

  // Column c of this thread: consecutive (VEC) or kThreads apart. Its x2
  // values are asked for first, to arrive while the rows are staged.
  const int base = blockIdx.x * kTile;
  auto col = [&](int c) { return VEC ? base + kCols * threadIdx.x + c : base + c * kThreads + threadIdx.x; };
  float xj[kCols][kDims];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = col(c);
    const float* b = x2 + g * x2_stride + (long long)j * D;
#pragma unroll
    for (int d = 0; d < kDims; ++d) xj[c][d] = (j < N && d < D) ? b[d] : 0.0f;
  }
  const float* a = x1 + g * x1_stride + (long long)i0 * D;
  for (int t = threadIdx.x; t < rows * D; t += kThreads) rows_x1[t] = a[t];
  __syncthreads();
  if (VEC && col(0) >= N) return;  // after the only barrier

  const float lls = log_ls[g * ls_stride];
  const float var = expf(log_var[g * var_stride]);
  const float inv_ls2 = expf(-2.0f * lls);
  const float inv_ls = expf(-lls);
  OutT* o = out + (g * M + i0) * (long long)N;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        if (d < D) {
          const float diff = rows_x1[r * D + d] - xj[c][d];
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
      }
      v[c] = gram_value<KIND>(acc, var, inv_ls, inv_ls2);
    }
    OutT* orow = o + (long long)r * N;
    if (VEC) {
      store4(orow + col(0), v);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (col(c) < N) store1(orow + col(c), v[c]);
    }
  }
}

template <int KIND, typename OutT>
int launch_kind(bool vec, dim3 grid, cudaStream_t s, const float* x1, long long x1_stride,
                const float* x2, long long x2_stride, const float* log_ls, int ls_stride,
                const float* log_var, int var_stride, OutT* out, int M, int N, int D) {
  using Kernel = void (*)(const float*, long long, const float*, long long, const float*, int,
                          const float*, int, OutT*, int, int, int);
  const Kernel k = D == 2 ? (vec ? gram_kernel<KIND, OutT, true, 2> : gram_kernel<KIND, OutT, false, 2>)
                          : (vec ? gram_kernel<KIND, OutT, true, 0> : gram_kernel<KIND, OutT, false, 0>);
  k<<<grid, kThreads, 0, s>>>(x1, x1_stride, x2, x2_stride, log_ls, ls_stride, log_var, var_stride,
                              out, M, N, D);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(int kind, bool vec, dim3 grid, cudaStream_t s, const float* x1, long long x1_stride,
           const float* x2, long long x2_stride, const float* log_ls, int ls_stride,
           const float* log_var, int var_stride, OutT* out, int M, int N, int D) {
  switch (kind) {
    case kRbf:
      return launch_kind<kRbf>(vec, grid, s, x1, x1_stride, x2, x2_stride, log_ls, ls_stride,
                               log_var, var_stride, out, M, N, D);
    case kMatern12:
      return launch_kind<kMatern12>(vec, grid, s, x1, x1_stride, x2, x2_stride, log_ls,
                                    ls_stride, log_var, var_stride, out, M, N, D);
    case kMatern32:
      return launch_kind<kMatern32>(vec, grid, s, x1, x1_stride, x2, x2_stride, log_ls,
                                    ls_stride, log_var, var_stride, out, M, N, D);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// The ranges the M rows are cut into at these sizes on the current device:
// at most kRows rows a block (the rows the kernel stages), fewer where that
// leaves fewer than kBlocksPerSm blocks a streaming multiprocessor, at least
// one. Negative: the CUDA error of the query.
long long sat_gram_row_splits(int G, int M, int N) {
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (sms <= 0) return -(long long)cudaErrorInvalidDevice;
  const long long tiles = (long long)(N + kTile - 1) / kTile * G;
  const long long by_card = ((long long)kBlocksPerSm * sms + tiles - 1) / tiles;
  const long long by_rows = (M + kRows - 1) / kRows;
  const long long s = by_card > by_rows ? by_card : by_rows;
  return s < M ? s : M;
}

// x1: (M, D) at x1_stride 0 or (G, M, D) at x1_stride M*D; x2 likewise with
// N; log_ls, log_var: one float (stride 0) or G floats (stride 1); out:
// (G, M, N) float32, or bfloat16 when out_bf16 != 0. All contiguous, on the
// device. kind: 0 rbf, 1 matern12, 2 matern32. The rows are cut as
// sat_gram_row_splits says. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int sat_gram_f32(const void* x1, long long x1_stride, const void* x2, long long x2_stride,
                 const void* log_ls, int ls_stride, const void* log_var, int var_stride,
                 void* out, int out_bf16, int G, int M, int N, int D, int kind, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  const long long splits = sat_gram_row_splits(G, M, N);
  if (splits < 0) return (int)-splits;
  if (D < 0 || D > kMaxDim || G > 65535 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kTile - 1) / kTile, G, (unsigned)splits);
  // 16-byte stores (8 for bfloat16) where every row starts aligned.
  const int align = out_bf16 ? 8 : 16;
  const bool vec = N % kCols == 0 && (uintptr_t)out % align == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)x1;
  const float* b = (const float*)x2;
  const float* ls = (const float*)log_ls;
  const float* lv = (const float*)log_var;
  if (out_bf16) {
    return launch(kind, vec, grid, s, a, x1_stride, b, x2_stride, ls, ls_stride, lv, var_stride,
                  (__nv_bfloat16*)out, M, N, D);
  }
  return launch(kind, vec, grid, s, a, x1_stride, b, x2_stride, ls, ls_stride, lv, var_stride,
                (float*)out, M, N, D);
}

// An empty kernel on `stream`: the floor of a launch, to time beside the
// Gram's small shapes. Returns cudaGetLastError().
int sat_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
