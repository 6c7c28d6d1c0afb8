// Batched Cholesky factor and its inverse, (L, L^-1), of float32 SPD
// matrices in one launch, for Hopper.
//
// Replaces the TPU kernel spatial_alignment_tpu/ops/pallas_factor.py
// (_make_kernel, launched by _fused_padded) behind cholesky_and_inverse.
// The TPU design (128-lane padding, U = L^T by rows, NB = 8 panels with
// one-hot lane reductions) does not carry over.
//
// Design: one block of 256 threads per matrix of the flattened batch.
//   1. The Cholesky recurrence of cholesky.cu (common.cuh) on the
//      matrix in shared memory; L ends up in the lower triangle.
//   2. L^-1 = W by column-oriented forward substitution against the
//      identity, all columns at once, two barriers per row j:
//        A: W[j][c] = B[j][c] / L_jj for c < j, W[j][j] = 1 / L_jj, and
//           column j of L below the diagonal to a buffer;
//        B: B[i][c] -= L_ij W[j][c] for i > j, c <= j.
//      Column c of W is zero above row c, so only the lower triangle is
//      worked. W's strict lower triangle is kept transposed in the upper
//      triangle of the same m x m buffer, which the recurrence never
//      touches, and its diagonal in a buffer of m floats: L and W together
//      take (m^2 + 2m) floats, 161,600 B at m = 200, under the 232,448 B a
//      block may have. Above m = 240 both phases run in place in global
//      memory on the output buffers (L's, and L^-1's by rows).
// NaN contract, as ops/cholesky.py: a pivot that is not > 0 marks the
// matrix as failed; its L and L^-1 are NaN over the whole lower triangle
// and 0 above. Other matrices are other blocks and stay untouched.
//
// What bounds it on the card: per matrix m^3/3 + m^3/3 multiply-adds on
// 4 m^2 bytes in and 8 m^2 bytes out. At the main path's (14, 200, 200) slab
// that is about 2 us of bytes against 1 us of operations. This first design
// is far from both: 5 m block-wide barriers in series per matrix, and one
// block per matrix (14 of 132 SMs busy), set its time.

#include "common.cuh"

namespace {

constexpr int kThreads = kCholThreads;

// W = L^-1 below the diagonal, from the lower triangle of the row-major
// m x m `a`: W[i][c] (i > c) is kept at w[i * w_row + c * w_col], and
// 1 / L_ii at diag[i]. col: m floats of shared memory.
__device__ void invert_lower(const float* a, int m, float* w, int w_row, int w_col,
                             float* col, float* diag) {
  const int tid = threadIdx.x;
  for (int t = tid; t < m * m; t += kThreads) {
    const int i = t / m;
    const int c = t - i * m;
    if (i > c) w[(size_t)i * w_row + (size_t)c * w_col] = 0.0f;  // B = I below the diagonal
  }
  __syncthreads();
  for (int j = 0; j < m; ++j) {
    const float ljj = a[(size_t)j * m + j];
    for (int c = tid; c < j; c += kThreads) w[(size_t)j * w_row + (size_t)c * w_col] /= ljj;
    if (tid == 0) diag[j] = 1.0f / ljj;
    for (int i = j + 1 + tid; i < m; i += kThreads) col[i] = a[(size_t)i * m + j];
    __syncthreads();  // row j of W and column j of L are complete
    const int rows = m - j - 1;
    const int ncol = j + 1;
    for (int t = tid; t < rows * ncol; t += kThreads) {
      // Neighbouring threads take neighbouring words of w.
      int i, c;
      if (w_row == 1) {
        c = t / rows;
        i = j + 1 + (t - c * rows);
      } else {
        const int r = t / ncol;
        i = j + 1 + r;
        c = t - r * ncol;
      }
      const float wjc = (c == j) ? diag[j] : w[(size_t)j * w_row + (size_t)c * w_col];
      w[(size_t)i * w_row + (size_t)c * w_col] -= col[i] * wjc;
    }
    __syncthreads();  // the rows below j are updated before row j + 1 is read
  }
}

__global__ void __launch_bounds__(kThreads)
factor_smem_kernel(const float* __restrict__ in, float* __restrict__ out_l,
                   float* __restrict__ out_inv, int m) {
  extern __shared__ float smem[];
  float* a = smem;           // m * m: L below, W^T above the diagonal
  float* col = a + m * m;    // m
  float* diag = col + m;     // m
  const size_t off = (size_t)blockIdx.x * m * m;
  const int mm = m * m;
  for (int t = threadIdx.x; t < mm; t += kThreads) a[t] = in[off + t];
  __syncthreads();
  const bool ok = factor_in_place(a, col, m);
  __syncthreads();
  if (ok) invert_lower(a, m, a, 1, m, col, diag);
  __syncthreads();
  const float nan = quiet_nan();
  for (int t = threadIdx.x; t < mm; t += kThreads) {
    const int r = t / m;
    const int c = t - r * m;
    out_l[off + t] = (c <= r) ? (ok ? a[t] : nan) : 0.0f;
    float v = 0.0f;
    if (c < r) v = ok ? a[c * m + r] : nan;
    else if (c == r) v = ok ? diag[r] : nan;
    out_inv[off + t] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
factor_global_kernel(const float* __restrict__ in, float* __restrict__ out_l,
                     float* __restrict__ out_inv, int m) {
  extern __shared__ float smem[];
  float* col = smem;       // m
  float* diag = col + m;   // m
  const size_t off = (size_t)blockIdx.x * m * m;
  float* a = out_l + off;    // L's output buffer is the workspace
  float* w = out_inv + off;  // W by rows in its own output buffer
  const size_t mm = (size_t)m * m;
  for (size_t t = threadIdx.x; t < mm; t += kThreads) a[t] = in[off + t];
  __syncthreads();
  const bool ok = factor_in_place(a, col, m);
  __syncthreads();
  if (ok) invert_lower(a, m, w, m, 1, col, diag);
  __syncthreads();
  const float nan = quiet_nan();
  for (size_t t = threadIdx.x; t < mm; t += kThreads) {
    const size_t r = t / m;
    const size_t c = t - r * m;
    a[t] = (c <= r) ? (ok ? a[t] : nan) : 0.0f;
    if (c > r) w[t] = 0.0f;
    else if (c == r) w[t] = ok ? diag[r] : nan;
    else if (!ok) w[t] = nan;
  }
}

}  // namespace

extern "C" {

// 1 when an m x m factor and inverse run in shared memory, 0 when they run
// in global memory, -1 on error.
int sat_factor_uses_smem(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return ((size_t)m * m + 2 * (size_t)m) * sizeof(float) <= (size_t)limit ? 1 : 0;
}

// in: `batch` contiguous row-major symmetric m x m float32 matrices on the
// device; out_l, out_inv: the same shape, L and L^-1. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int sat_factor_f32(const void* in, void* out_l, void* out_inv, long long batch, int m,
                   void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = ((size_t)m * m + 2 * (size_t)m) * sizeof(float);
  if (smem <= (size_t)limit) {
    cudaError_t e = cudaFuncSetAttribute(
        factor_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    factor_smem_kernel<<<(unsigned)batch, kThreads, smem, s>>>(
        (const float*)in, (float*)out_l, (float*)out_inv, m);
  } else {
    const size_t bufs = 2 * (size_t)m * sizeof(float);
    if (bufs > (size_t)limit) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        factor_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bufs);
    if (e != cudaSuccess) return (int)e;
    factor_global_kernel<<<(unsigned)batch, kThreads, bufs, s>>>(
        (const float*)in, (float*)out_l, (float*)out_inv, m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
