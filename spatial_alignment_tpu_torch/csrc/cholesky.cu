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
// the chain of dependent steps in one matrix, each ended by a barrier: per
// 32-column panel, the 32 pivots of the diagonal block and the 32-step
// solve of each row below it (tools/panel_trace.py times them).
//
// Design: one thread block of 256 threads per matrix of the flattened
// batch, running the blocked right-looking routine of common.cuh, which
// the fused factor (factor.cu) runs too: panels of 32 columns, warp 0
// factoring each diagonal block with shuffles, warps 1..7 solving the rows
// below it, 8 x 8 register tiles updating the lower triangle only, and the
// next diagonal block updated first and factored beside the rest of the
// trailing update (look-ahead): 2P + 1 barriers for P = ceil(m / 32)
// panels, 15 at m = 200 and 25 at m = 384. Up to m = 240 the matrix is
// staged into shared memory with cp.async (rows padded to m + 1 floats);
// above, it stays in global memory (the output buffer, in L2) and only the
// diagonal block and the panel live in shared memory (the panel design of
// common.cuh), and from m = 384 on a thread-block cluster of 4 blocks
// shares each matrix (fewer where the batch's clusters would not fit the
// card at once). Both round as the column recurrence, IEEE square roots and
// divisions included, so L is the same bit for bit here, in the fused
// factor and in the recurrence at every m. The recurrence itself
// (recurrence_kernel, the first design: one column a step, three barriers a
// column, in place in global memory) stays as a reference entry,
// sat_cholesky_recurrence_f32, which only the tests and the smoke call.
//
// NaN contract (the jitter probes of ops/linalg.py test the factor for NaN):
// a pivot that is not > 0 (negative, zero or NaN) marks the matrix as failed,
// and its whole lower triangle is written as NaN; the upper triangle is 0.
// Other matrices of the batch are independent blocks and are unaffected.

#include "common.cuh"

namespace {

constexpr int kThreads = kCholThreads;

__global__ void __launch_bounds__(kThreads, 1)
cholesky_smem_kernel(const float* __restrict__ in, float* __restrict__ out, float*, int m) {
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

// The panel design: P in shared memory (kSmemPanel) or in `scratch` (a
// panel a matrix); kVec: m % 4 == 0 and in, out 16-byte aligned; kCluster:
// each matrix factored by one thread-block cluster (consecutive blocks).
template <bool kSmemPanel, bool kVec, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
cholesky_panel_kernel(const float* __restrict__ in, float* __restrict__ out,
                      float* __restrict__ scratch, int m) {
  extern __shared__ float4 smem4[];
  const Team<kCluster> team;
  const size_t mat = blockIdx.x / team.size;
  float* dblk = reinterpret_cast<float*>(smem4);  // NB x kLdd: the diagonal block
  float* diag = dblk + NB * kLdd;                 // m: 1 / L_ii, unused here
  float* P = kSmemPanel ? diag + round4(m) : scratch + mat * panel_buffer_floats(m, false);
  const size_t off = mat * m * m;
  __shared__ int failed;
  const bool ok = panel_cholesky<false, kSmemPanel, kVec, kCluster>(
      in + off, out + off, nullptr, dblk, diag, P, &failed, m, team);
  finish_lower(out + off, m, ok, team.rank, team.size);
}

// The column recurrence, the reference whose rounding the blocked designs
// keep: right-looking elimination on the row-major m x m matrix `a`
// (global memory) with the shared column buffer `col` (m floats), by a
// block of kThreads threads. Reads and writes only the lower triangle.
//   1. every thread reads the pivot A[j][j];                  barrier
//   2. column j below the diagonal is scaled by 1/sqrt(pivot)
//      and copied to the column buffer;                       barrier
//   3. the trailing lower triangle takes the rank-1 update
//      A[i][k] -= L[i][j] L[k][j], strided over the threads.  barrier
// Returns false when a pivot was not > 0 (negative, zero or NaN); the same
// value in every thread.
__device__ bool factor_in_place(float* a, float* col, int m) {
  const int tid = threadIdx.x;
  for (int j = 0; j < m; ++j) {
    const float piv = a[j * m + j];
    __syncthreads();  // every thread has read the pivot before it is written
    if (!(piv > 0.0f)) {
      return false;  // uniform: every thread read the same pivot
    }
    const float d = sqrtf(piv);
    for (int i = j + tid; i < m; i += kThreads) {
      const float v = (i == j) ? d : a[i * m + j] / d;
      a[i * m + j] = v;
      col[i] = v;
    }
    __syncthreads();  // column j of L is complete
    const int n = m - j - 1;  // trailing size
    const int base = j + 1;
    for (int t = tid; t < n * n; t += kThreads) {
      const int r = t / n;
      const int c = t - r * n;
      if (c <= r) {
        a[(base + r) * m + base + c] -= col[base + r] * col[base + c];
      }
    }
    __syncthreads();  // trailing update visible before the next pivot read
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
recurrence_kernel(const float* __restrict__ in, float* __restrict__ out, int m) {
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

// The design that factors an m x m matrix under the shared-memory limit:
// 0 the whole matrix in shared memory, 1 the panel design with the panel in
// shared memory, 2 the panel design with the panel in global memory.
int design(int m, int limit) {
  if (blocked_smem_bytes(m) <= (size_t)limit) return 0;
  const size_t panel = (panel_fixed_floats(m, false) + panel_buffer_floats(m, false)) * sizeof(float);
  return panel + 64 <= (size_t)limit ? 1 : 2;
}

size_t design_smem(int m, int d) {
  if (d == 0) return blocked_smem_bytes(m);
  return (panel_fixed_floats(m, false) + (d == 1 ? panel_buffer_floats(m, false) : 0)) * sizeof(float);
}

// Blocks per matrix of the design for `batch` m x m matrices: a cluster
// (panel_cluster) when the panel is in shared memory, else 1.
int blocks_per_matrix(long long batch, int m, int limit) {
  return design(m, limit) == 1 ? panel_cluster(batch, m) : 1;
}

// Launch the design for m on `batch` matrices with `cluster` blocks a
// matrix (1, or 2 to 8 where the panel is in shared memory).
int launch_design(const float* in, float* out, float* scratch, long long batch, int m,
                  int cluster, int limit, cudaStream_t s) {
  const int d = design(m, limit);
  const size_t smem = design_smem(m, d);
  if (d == 2 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > 8 || (cluster > 1 && d != 1)) return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  const unsigned n = (unsigned)batch;
  const unsigned nc = n * (unsigned)cluster;
  if (d == 0) return launch_panel(cholesky_smem_kernel, smem, n, 1, s, in, out, scratch, m);
  if (d == 1 && cluster > 1)
    return vec ? launch_panel(cholesky_panel_kernel<true, true, true>, smem, nc, cluster, s, in,
                              out, scratch, m)
               : launch_panel(cholesky_panel_kernel<true, false, true>, smem, nc, cluster, s,
                              in, out, scratch, m);
  if (d == 1)
    return vec ? launch_panel(cholesky_panel_kernel<true, true, false>, smem, n, 1, s, in, out,
                              scratch, m)
               : launch_panel(cholesky_panel_kernel<true, false, false>, smem, n, 1, s, in, out,
                              scratch, m);
  return vec ? launch_panel(cholesky_panel_kernel<false, true, false>, smem, n, 1, s, in, out,
                            scratch, m)
             : launch_panel(cholesky_panel_kernel<false, false, false>, smem, n, 1, s, in, out,
                            scratch, m);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block may opt in to on the current
// device (-1 on error).
int sat_cholesky_smem_limit() { return smem_optin_limit(); }

// 1 when an m x m factorization runs in shared memory (the blocked design),
// 0 when it runs the panel design (trailing matrix in global memory), -1 on
// error.
int sat_cholesky_uses_smem(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return design(m, limit) == 0 ? 1 : 0;
}

// The design for an m x m matrix: 0 the whole matrix in shared memory, 1
// the panel design with the panel in shared memory, 2 with the panel in
// global memory; -1 on error.
int sat_cholesky_design(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return design(m, limit);
}

// Columns per panel of either design.
int sat_cholesky_panel() { return NB; }

// Thread blocks per matrix for `batch` m x m matrices on the current
// device: a thread-block cluster of up to 4 in the panel design with the
// panel in shared memory from m = 384 on, else 1; -1 on error.
int sat_cholesky_blocks_per_matrix(long long batch, int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return blocks_per_matrix(batch, m, limit);
}

// Dynamic shared memory of one block for an m x m matrix, in bytes.
long long sat_cholesky_smem_bytes(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return (long long)design_smem(m, design(m, limit));
}

// Floats of scratch in global memory sat_cholesky_f32 needs for `batch`
// m x m matrices (0 when the panel fits shared memory), or -1 on error.
long long sat_cholesky_scratch_floats(long long batch, int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return design(m, limit) == 2 ? batch * (long long)panel_buffer_floats(m, false) : 0;
}

// in, out: `batch` contiguous row-major m x m float32 matrices on the device;
// scratch: sat_cholesky_scratch_floats(batch, m) floats on the device (may
// be null when that is 0). Launches on `stream` with
// sat_cholesky_blocks_per_matrix(batch, m) blocks a matrix and returns
// cudaGetLastError() (0 = launched).
int sat_cholesky_f32(const void* in, void* out, void* scratch, long long batch, int m,
                     void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  return launch_design((const float*)in, (float*)out, (float*)scratch, batch, m,
                       blocks_per_matrix(batch, m, limit), limit, (cudaStream_t)stream);
}

// The same with `cluster` blocks a matrix (1, or 2 to 8 where the panel
// design keeps its panel in shared memory), to time one choice against
// another.
int sat_cholesky_f32_blocks(const void* in, void* out, void* scratch, long long batch, int m,
                            int cluster, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  return launch_design((const float*)in, (float*)out, (float*)scratch, batch, m, cluster, limit,
                       (cudaStream_t)stream);
}

// The column recurrence (the first design), kept as the reference whose
// rounding the kernel keeps: the same arguments and result as
// sat_cholesky_f32. Only the tests and the smoke call it.
int sat_cholesky_recurrence_f32(const void* in, void* out, long long batch, int m,
                                void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  const size_t col_bytes = (size_t)m * sizeof(float);
  if (col_bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(recurrence_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)col_bytes);
  if (e != cudaSuccess) return (int)e;
  recurrence_kernel<<<(unsigned)batch, kThreads, col_bytes, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
