// Batched Cholesky factor and its inverse, (L, L^-1), of float32 SPD
// matrices in one launch, for Hopper.
//
// Replaces the TPU kernel spatial_alignment_tpu/ops/pallas_factor.py
// (_make_kernel, launched by _fused_padded) behind cholesky_and_inverse.
// The TPU design (128-lane padding, U = L^T by rows, NB = 8 panels with
// one-hot lane reductions) does not carry over.
//
// What bounds it on the card: per matrix m^3/3 + m^3/3 multiply-adds on
// 4 m^2 bytes in and 8 m^2 bytes out. At the main path's (14, 200, 200) slab
// that is about 2 us of bytes against 1 us of operations. What sets the time
// is the chain of dependent steps, each ended by a block barrier: the first
// design took one column per step, 5 m barriers in series per matrix.
//
// Design, up to m = 240: one block of 256 threads (8 warps) per matrix,
// the matrix staged into shared memory with cp.async, rows padded to m + 1
// floats. The Cholesky is the blocked routine of common.cuh, which the
// Cholesky kernel (cholesky.cu) runs too: panels of NB = 32 columns, warp 0
// factoring each diagonal block with shuffles and here also inverting it
// from its registers (W11 kept transposed above the block's diagonal),
// warps 1..7 solving the rows below, 8 x 8 register tiles updating the
// lower triangle, the next diagonal block factored beside the trailing
// update: 2P + 1 barriers for P = ceil(m / NB) panels. Its L rounds as the
// column-at-a-time recurrence, so it is the Cholesky kernel's bit for bit,
// the default route's factor: the init's Grams (cond ~1e6) magnify any
// other rounding, and with L rounded otherwise the opt-in route's first
// loss parted from the default route's by up to 1.44e-3 (PERF.md).
//   Inverse, W = L^-1 by blocked forward substitution against I, for each
//   block row K (B = I below the diagonal, B_KK = I, so W_KK = W11 of panel
//   K), two barriers:
//     d. W_KJ = W_KK B_KJ for J < K: a thread a column, in registers.
//                                                                   barrier
//     e. below block row K: B_IK = -L_IK W_KK (B was I there), a thread a
//        row; B_IJ -= L_IK W_KJ for J < K, 8 x 8 register tiles.    barrier
//   (2P + 1) + 2(P - 1) + 2 barriers per matrix: 29 at m = 200 (1,000 in the
//   first design). A design with every warp factoring the diagonal block
//   itself was slower (PERF.md): eight warps on the same shuffles. W's
//   strict lower triangle is kept transposed in the upper triangle of the
//   same buffer and its diagonal in m floats: (m^2 + 2m) floats in all,
//   161,600 B at m = 200, 232,320 B at m = 240 under the 232,448 B a block
//   may have. The inverse multiplies by 1 / L_ii and by W_KK, which is
//   faster than the recurrence's division.
// One block per matrix: 14 of 132 SMs at (14, 200, 200).
// Above m = 240 the same steps run in the panel design of common.cuh: L in
// the output buffer in global memory, the diagonal block and the panel in
// shared memory, each W11 written into W's diagonal block; then W by the
// same blocked substitution (panel_inverse) with W in its own output
// buffer, the panel of L and the block row of W in shared memory (48 KB
// and 72 KB at m = 384), three barriers a block row, one block a matrix
// (a thread-block cluster, which speeds the Cholesky from m = 384 on, was
// slower here: PERF.md). L is the Cholesky kernel's bit for bit at every
// m; W multiplies by 1 / L_ii and by W_KK, as below 240.
// NaN contract, as ops/cholesky.py: a pivot that is not > 0 marks the
// matrix as failed; its L and L^-1 are NaN over the whole lower triangle
// and 0 above. Other matrices are other blocks and stay untouched.

#include "common.cuh"

namespace {

constexpr int kThreads = kCholThreads;

// W = L^-1 by blocked forward substitution, W[i][c] (i > c) at a[c ld + i].
__device__ void blocked_inverse(float* a, const float* diag, int m, int ld) {
  const int tid = threadIdx.x;
  for (int K0 = 0; K0 < m; K0 += NB) {
    const int kb = min(NB, m - K0);
    const int K1 = K0 + kb;
    if (K0 > 0) {
      // (d) W_KJ = W_KK B_KJ, one column c < K0 a thread.
      for (int c = tid; c < K0; c += kThreads) {
        float* col = a + c * ld + K0;
        float v[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) v[i] = i < kb ? col[i] : 0.0f;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          if (i < kb) {
            float s = diag[K0 + i] * v[i];
#pragma unroll
            for (int k = 0; k < i; ++k) s = fmaf(a[(K0 + k) * ld + K0 + i], v[k], s);
            col[i] = s;
          }
        }
      }
      __syncthreads();
    }
    if (K1 < m) {
      // (e) below block row K (K1 is a multiple of NB here):
      // block K's own columns, B_IK = -L_IK W_KK (B was I there), one row
      // a thread with W_KK read by every thread at once;
      for (int r = K1 + tid; r < m; r += kThreads) {
        float x[NB];
#pragma unroll
        for (int k = 0; k < NB; ++k) x[k] = a[r * ld + K0 + k];
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          float s = x[c] * diag[K0 + c];
#pragma unroll
          for (int k = c + 1; k < NB; ++k) s = fmaf(x[k], a[(K0 + c) * ld + K0 + k], s);
          a[(K0 + c) * ld + r] = -s;
        }
      }
      // the earlier columns, B_IJ -= L_IK W_KJ for J < K, 8 x 8 register
      // tiles; u = L[r][k] at a[r ld + k] and v = W[k][c] at a[c ld + k]
      // both have k as the unit stride.
      const int nr = (m - K1 + TS - 1) / TS;
      const int nc = K0 / TS;
      for (int t = tid; t < nr * nc; t += kThreads) {
        const int tr = t / nc;
        const int tc = t - tr * nc;
        const int r0 = K1 + TS * tr;
        int ri[TS], cj[TS];  // columns are all < K0; rows may pass m
        rotated(ri, r0, tr);
        rotated(cj, TS * tc, tc);
        int ui[TS], vj[TS];
#pragma unroll
        for (int i = 0; i < TS; ++i) {
          ui[i] = min(ri[i], m - 1) * ld;
          vj[i] = cj[i] * ld;
        }
        float acc[TS][TS];
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
          for (int j = 0; j < TS; ++j) acc[i][j] = a[vj[j] + min(ri[i], m - 1)];
        tile_update(acc, K0, K1, a, 1, ui, a, 1, vj);
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
          for (int j = 0; j < TS; ++j)
            if (ri[i] < m) a[vj[j] + ri[i]] = acc[i][j];
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
factor_smem_kernel(const float* __restrict__ in, float* __restrict__ out_l,
                   float* __restrict__ out_inv, float*, int m) {
  extern __shared__ float smem[];
  const int ld = m + 1;
  float* a = smem;            // m x ld: L below, W^T above the diagonal
  float* diag = a + m * ld;   // m: 1 / L_ii, the diagonal of W
  const size_t off = (size_t)blockIdx.x * m * m;
  stage_padded(a, in + off, m, ld);
  __shared__ int failed;
  const bool ok = blocked_cholesky<true>(a, diag, &failed, m, ld);
  if (ok) blocked_inverse(a, diag, m, ld);
  __syncthreads();
  const float nan = quiet_nan();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32) {
      const size_t o = off + (size_t)r * m + c;
      out_l[o] = c <= r ? (ok ? a[r * ld + c] : nan) : 0.0f;
      float v = 0.0f;
      if (c < r) v = ok ? a[c * ld + r] : nan;
      else if (c == r) v = ok ? diag[r] : nan;
      out_inv[o] = v;
    }
}

// The panel design: the panels in shared memory (kSmemPanel) or in
// `scratch` (panel_buffer_floats(m, true) a matrix); kVec: m % 4 == 0 and in,
// out_l, out_inv 16-byte aligned. One block a matrix.
template <bool kSmemPanel, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
factor_panel_kernel(const float* __restrict__ in, float* __restrict__ out_l,
                    float* __restrict__ out_inv, float* __restrict__ scratch, int m) {
  extern __shared__ float4 smem4[];
  const Team<false> team;
  const size_t mat = blockIdx.x;
  float* dblk = reinterpret_cast<float*>(smem4);  // NB x kLdd: the diagonal block
  float* diag = dblk + NB * kLdd;                 // m: 1 / L_ii, the diagonal of W
  float* xbuf = diag + round4(m);                 // kWarps x NB x kLdd
  float* wp = kSmemPanel ? xbuf + kWarps * NB * kLdd  // NB x padded_ld(m): P, then W's rows
                         : scratch + mat * panel_buffer_floats(m, true);
  float* lp = wp + NB * padded_ld(m);  // NB x round4(m): L's panel
  const size_t off = mat * m * m;
  float* a = out_l + off;
  float* w = out_inv + off;
  __shared__ int failed;
  const bool ok = panel_cholesky<true, kSmemPanel, kVec>(in + off, a, w, dblk, diag, wp,
                                                         &failed, m, team);
  if (ok) panel_inverse<kSmemPanel, kVec>(a, w, dblk, diag, lp, wp, xbuf, m);
  __syncthreads();
  finish_lower(a, m, ok, 0, 1);
  const float nan = quiet_nan();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < m; r += kWarps) {
    float* row = w + (size_t)r * m;
    for (int c = (ok ? r : 0) + lane; c < m; c += 32)
      row[c] = c > r ? 0.0f : (ok ? diag[r] : nan);
  }
}

// The design for an m x m factor under the shared-memory limit: 0 the whole
// matrix in shared memory, 1 the panel design with its panels in shared
// memory, 2 with them in global memory.
int design(int m, int limit) {
  if (blocked_smem_bytes(m) <= (size_t)limit) return 0;
  const size_t panel = (panel_fixed_floats(m, true) + panel_buffer_floats(m, true)) * sizeof(float);
  return panel + 64 <= (size_t)limit ? 1 : 2;
}

size_t design_smem(int m, int d) {
  if (d == 0) return blocked_smem_bytes(m);
  return (panel_fixed_floats(m, true) + (d == 1 ? panel_buffer_floats(m, true) : 0)) * sizeof(float);
}

// Launch the design for m on `batch` matrices, one block a matrix.
int launch_design(const float* in, float* l, float* v, float* scratch, long long batch, int m,
                  int limit, cudaStream_t s) {
  const int d = design(m, limit);
  const size_t smem = design_smem(m, d);
  if (d == 2 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && ((uintptr_t)in | (uintptr_t)l | (uintptr_t)v) % 16 == 0;
  const unsigned n = (unsigned)batch;
  if (d == 0) return launch_panel(factor_smem_kernel, smem, n, 1, s, in, l, v, scratch, m);
  if (d == 1)
    return vec ? launch_panel(factor_panel_kernel<true, true>, smem, n, 1, s, in, l, v, scratch, m)
               : launch_panel(factor_panel_kernel<true, false>, smem, n, 1, s, in, l, v, scratch,
                              m);
  return vec ? launch_panel(factor_panel_kernel<false, true>, smem, n, 1, s, in, l, v, scratch, m)
             : launch_panel(factor_panel_kernel<false, false>, smem, n, 1, s, in, l, v, scratch,
                            m);
}

}  // namespace

extern "C" {

// Columns per panel of either design.
int sat_factor_panel() { return NB; }

// 1 when an m x m factor and inverse run in shared memory, 0 when they run
// the panel design (the matrices in global memory), -1 on error.
int sat_factor_uses_smem(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return design(m, limit) == 0 ? 1 : 0;
}

// The design for an m x m factor: 0 the whole matrix in shared memory, 1
// the panel design with its panels in shared memory, 2 with them in global
// memory; -1 on error.
int sat_factor_design(int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return design(m, limit);
}

// Floats of scratch in global memory sat_factor_f32 needs for `batch`
// m x m matrices (0 when the panels fit shared memory), or -1 on error.
long long sat_factor_scratch_floats(long long batch, int m) {
  const int limit = smem_optin_limit();
  if (limit < 0) return -1;
  return design(m, limit) == 2 ? batch * (long long)panel_buffer_floats(m, true) : 0;
}

// in: `batch` contiguous row-major symmetric m x m float32 matrices on the
// device; out_l, out_inv: the same shape, L and L^-1; scratch:
// sat_factor_scratch_floats(batch, m) floats on the device (may be null
// when that is 0). Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
int sat_factor_f32(const void* in, void* out_l, void* out_inv, void* scratch, long long batch,
                   int m, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  const int limit = smem_optin_limit();
  if (limit < 0) return (int)cudaGetLastError();
  return launch_design((const float*)in, (float*)out_l, (float*)out_inv, (float*)scratch, batch,
                       m, limit, (cudaStream_t)stream);
}

}  // extern "C"
