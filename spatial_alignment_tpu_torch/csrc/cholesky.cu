// Batched lower Cholesky factorization of float32 SPD matrices, for Hopper.
//
// Replaces the TPU kernel spatial_alignment_tpu/ops/pallas_cholesky.py:cholesky
// (kernel body _make_kernel, launched by _chol_pallas_padded). The JAX
// package sends every f32 Cholesky with m >= 48 and batch >= 2 there; on the
// GPU the port sends every Cholesky of a CUDA tensor here.
//
// Design: one thread block per matrix of the flattened batch, 256 threads,
// right-looking elimination column by column:
//   1. every thread reads the pivot A[j][j];                  barrier
//   2. column j below the diagonal is scaled by 1/sqrt(pivot)
//      and copied to a small shared column buffer;            barrier
//   3. the trailing lower triangle takes the rank-1 update
//      A[i][k] -= L[i][j] L[k][j], strided over the threads.  barrier
// The matrix lives in dynamic shared memory when (m*m + m) floats fit in the
// block's opt-in limit (m <= 238 on an H100). Above that, the same recurrence
// runs in place on the output buffer in global memory, with only the column
// buffer in shared memory. Nothing is padded: an m x m matrix is worked at
// m x m.
//
// NaN contract (the jitter probes of ops/linalg.py test the factor for NaN):
// a pivot that is not > 0 (negative, zero or NaN) marks the matrix as failed,
// and its whole lower triangle is written as NaN; the upper triangle is 0.
// Other matrices of the batch are independent blocks and are unaffected.
//
// What bounds it on the card: per matrix, ~m^3/3 multiply-adds on m*m*4 bytes
// read and m*m*4 written. At the main path's shapes, e.g. (14, 200, 200),
// that is ~3.7e7 FLOP and ~4.5 MB, a bound of about a microsecond. This first
// design is far from it: the m-step serial dependency with three block-wide
// barriers per column, and at most one block per matrix (14 of 132 SMs busy
// at batch 14), set its time, not bytes or FLOPs.

#include "common.cuh"

namespace {

constexpr int kThreads = kCholThreads;

__global__ void __launch_bounds__(kThreads)
cholesky_smem_kernel(const float* __restrict__ in, float* __restrict__ out, int m) {
  extern __shared__ float smem[];
  float* a = smem;          // m * m
  float* col = smem + m * m;  // m
  const size_t off = (size_t)blockIdx.x * m * m;
  const float* src = in + off;
  float* dst = out + off;
  const int mm = m * m;
  for (int t = threadIdx.x; t < mm; t += kThreads) a[t] = src[t];
  __syncthreads();
  const bool ok = factor_in_place(a, col, m);
  __syncthreads();
  const float nan = quiet_nan();
  for (int t = threadIdx.x; t < mm; t += kThreads) {
    const int r = t / m;
    const int c = t - r * m;
    dst[t] = (c <= r) ? (ok ? a[t] : nan) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
cholesky_global_kernel(const float* __restrict__ in, float* __restrict__ out, int m) {
  extern __shared__ float col[];  // m
  const size_t off = (size_t)blockIdx.x * m * m;
  const float* src = in + off;
  float* a = out + off;  // the output buffer is the workspace
  const size_t mm = (size_t)m * m;
  for (size_t t = threadIdx.x; t < mm; t += kThreads) a[t] = src[t];
  __syncthreads();
  const bool ok = factor_in_place(a, col, m);
  __syncthreads();
  const float nan = quiet_nan();
  for (size_t t = threadIdx.x; t < mm; t += kThreads) {
    const size_t r = t / m;
    const size_t c = t - r * m;
    a[t] = (c <= r) ? (ok ? a[t] : nan) : 0.0f;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block may opt in to on the current
// device (-1 on error).
int sat_cholesky_smem_limit() { return smem_optin_limit(); }

// 1 when an m x m factorization runs in shared memory, 0 when it runs in
// global memory, -1 on error.
int sat_cholesky_uses_smem(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return ((size_t)m * m + m) * sizeof(float) <= (size_t)limit ? 1 : 0;
}

// in, out: `batch` contiguous row-major m x m float32 matrices on the device.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int sat_cholesky_f32(const void* in, void* out, long long batch, int m, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = ((size_t)m * m + m) * sizeof(float);
  if (smem <= (size_t)limit) {
    cudaError_t e = cudaFuncSetAttribute(
        cholesky_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cholesky_smem_kernel<<<(unsigned)batch, kThreads, smem, s>>>(
        (const float*)in, (float*)out, m);
  } else {
    const size_t col_bytes = (size_t)m * sizeof(float);
    if (col_bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        cholesky_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)col_bytes);
    if (e != cudaSuccess) return (int)e;
    cholesky_global_kernel<<<(unsigned)batch, kThreads, col_bytes, s>>>(
        (const float*)in, (float*)out, m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
