// Batched lower Cholesky factorization of float32 SPD matrices, for Hopper.
//
// Replaces the TPU kernel spatial_alignment_tpu/ops/pallas_cholesky.py:cholesky
// (kernel body _make_kernel, launched by _chol_pallas_padded). The JAX
// package sends every f32 Cholesky with m >= 48 and batch >= 2 there; on the
// GPU the port sends every Cholesky of a CUDA tensor here.
//
// What bounds it on the card: per matrix, ~m^3/3 flops on m*m*4 bytes read
// and m*m*4 written. At the main path's (14, 200, 200) slab that is ~3.7e7
// flops and ~4.5 MB, a bound of about a microsecond. What sets the time is
// the chain of dependent steps in one matrix, each ended by a block
// barrier, and one block per matrix (14 of 132 SMs busy at batch 14).
//
// Design: one thread block of 256 threads per matrix of the flattened
// batch. Up to m = 240 the matrix is staged into shared memory with
// cp.async (rows padded to m + 1 floats) and factored by the blocked
// right-looking routine of common.cuh, which the fused factor (factor.cu)
// runs too: panels of 32 columns, warp 0 factoring each diagonal block
// with shuffles, warps 1..7 solving the rows below it, 8 x 8 register tiles
// updating the lower triangle only, and the next diagonal block updated
// first and factored beside the rest of the trailing update (look-ahead):
// 2P + 1 barriers for P = ceil(m / 32) panels, 15 at m = 200 (600 in the
// first design, the column recurrence). Its rounding is the column
// recurrence's, IEEE square roots and divisions included, so L is the same
// bit for bit here, in the fused factor and in the first design. Above
// m = 240 the column recurrence (factor_in_place) runs in place on the
// output buffer in global memory, with only a column buffer in shared
// memory: off the main paths.
//
// NaN contract (the jitter probes of ops/linalg.py test the factor for NaN):
// a pivot that is not > 0 (negative, zero or NaN) marks the matrix as failed,
// and its whole lower triangle is written as NaN; the upper triangle is 0.
// Other matrices of the batch are independent blocks and are unaffected.

#include "common.cuh"

namespace {

constexpr int kThreads = kCholThreads;

__global__ void __launch_bounds__(kThreads, 1)
cholesky_smem_kernel(const float* __restrict__ in, float* __restrict__ out, int m) {
  extern __shared__ float smem[];
  const int ld = m + 1;
  float* a = smem;           // m x ld
  float* diag = a + m * ld;  // m: 1 / L_ii, written by the routine, unused here
  const size_t off = (size_t)blockIdx.x * m * m;
  stage_padded(a, in + off, m, ld);
  __shared__ int failed;
  const bool ok = blocked_cholesky<false>(a, diag, &failed, m, ld);
  __syncthreads();
  const float nan = quiet_nan();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32)
      out[off + (size_t)r * m + c] = c <= r ? (ok ? a[r * ld + c] : nan) : 0.0f;
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

// 1 when an m x m factorization runs in shared memory (the blocked design),
// 0 when it runs in global memory, -1 on error.
int sat_cholesky_uses_smem(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return blocked_smem_bytes(m) <= (size_t)limit ? 1 : 0;
}

// Columns per panel of the shared-memory design.
int sat_cholesky_panel() { return NB; }

// Thread blocks per matrix (one: a matrix never spans SMs).
int sat_cholesky_blocks_per_matrix() { return 1; }

// Dynamic shared memory of one block for an m x m matrix, in bytes.
long long sat_cholesky_smem_bytes(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  const size_t smem = blocked_smem_bytes(m);
  return (long long)(smem <= (size_t)limit ? smem : (size_t)m * sizeof(float));
}

// in, out: `batch` contiguous row-major m x m float32 matrices on the device.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int sat_cholesky_f32(const void* in, void* out, long long batch, int m, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = blocked_smem_bytes(m);
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
