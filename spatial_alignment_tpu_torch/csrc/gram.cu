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
// Design: a block of 256 threads owns 256 consecutive columns j of one group
// and a range of kRows rows i. Each thread keeps its x2_j in registers and
// loops over the rows, which the block first stages in shared memory.
// Consecutive threads write consecutive j, so each warp's store of a row is
// one 128-byte (float32) or 64-byte (bfloat16) transaction.
//
// What bounds it on the card: the output. Per element it reads nothing new
// (x1 from shared memory, x2 from registers) and does about 3D + 8 float
// operations (one or two of them transcendental), against 4 bytes written:
// at the data layer's (5, 100, 8192) that is 16.4 MB, about 4.9 us at
// 3.35 TB/s, with ~5.7e7 operations, under 1 us at 67 TFLOP/s. So it is
// bound by bytes; the row loop keeps many stores in flight per thread.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;    // rows of x1 per block
constexpr int kMaxDim = 8;   // D <= 8

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int KIND, typename OutT>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x1, long long x1_stride,
            const float* __restrict__ x2, long long x2_stride,
            const float* __restrict__ log_ls, int ls_stride,
            const float* __restrict__ log_var, int var_stride,
            OutT* __restrict__ out, int M, int N, int D) {
  __shared__ float rows_x1[kRows * kMaxDim];
  const long long g = blockIdx.y;
  const int i0 = blockIdx.z * kRows;
  const int rows = min(kRows, M - i0);
  const float* a = x1 + g * x1_stride + (long long)i0 * D;
  for (int t = threadIdx.x; t < rows * D; t += kThreads) rows_x1[t] = a[t];
  __syncthreads();

  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;  // after the only barrier
  float xj[kMaxDim];
  const float* b = x2 + g * x2_stride + (long long)j * D;
#pragma unroll
  for (int d = 0; d < kMaxDim; ++d) xj[d] = (d < D) ? b[d] : 0.0f;

  const float lls = log_ls[g * ls_stride];
  const float var = expf(log_var[g * var_stride]);
  const float inv_ls2 = expf(-2.0f * lls);
  const float inv_ls = expf(-lls);
  OutT* o = out + (g * M + i0) * (long long)N + j;
  for (int r = 0; r < rows; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxDim; ++d) {
      if (d < D) {
        const float diff = rows_x1[r * D + d] - xj[d];
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
    }
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
    store(o + (long long)r * N, v);
  }
}

template <typename OutT>
int launch(int kind, dim3 grid, cudaStream_t s, const float* x1, long long x1_stride,
           const float* x2, long long x2_stride, const float* log_ls, int ls_stride,
           const float* log_var, int var_stride, OutT* out, int M, int N, int D) {
  switch (kind) {
    case kRbf:
      gram_kernel<kRbf, OutT><<<grid, kThreads, 0, s>>>(
          x1, x1_stride, x2, x2_stride, log_ls, ls_stride, log_var, var_stride, out, M, N, D);
      break;
    case kMatern12:
      gram_kernel<kMatern12, OutT><<<grid, kThreads, 0, s>>>(
          x1, x1_stride, x2, x2_stride, log_ls, ls_stride, log_var, var_stride, out, M, N, D);
      break;
    case kMatern32:
      gram_kernel<kMatern32, OutT><<<grid, kThreads, 0, s>>>(
          x1, x1_stride, x2, x2_stride, log_ls, ls_stride, log_var, var_stride, out, M, N, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x1: (M, D) at x1_stride 0 or (G, M, D) at x1_stride M*D; x2 likewise with
// N; log_ls, log_var: one float (stride 0) or G floats (stride 1); out:
// (G, M, N) float32, or bfloat16 when out_bf16 != 0. All contiguous, on the
// device. kind: 0 rbf, 1 matern12, 2 matern32. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int sat_gram_f32(const void* x1, long long x1_stride, const void* x2, long long x2_stride,
                 const void* log_ls, int ls_stride, const void* log_var, int var_stride,
                 void* out, int out_bf16, int G, int M, int N, int D, int kind, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if (D < 0 || D > kMaxDim || G > 65535 || (M + kRows - 1) / kRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kThreads - 1) / kThreads, G, (M + kRows - 1) / kRows);
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)x1;
  const float* b = (const float*)x2;
  const float* ls = (const float*)log_ls;
  const float* lv = (const float*)log_var;
  if (out_bf16) {
    return launch(kind, grid, s, a, x1_stride, b, x2_stride, ls, ls_stride, lv, var_stride,
                  (__nv_bfloat16*)out, M, N, D);
  }
  return launch(kind, grid, s, a, x1_stride, b, x2_stride, ls, ls_stride, lv, var_stride,
                (float*)out, M, N, D);
}

}  // extern "C"
