// The band-sparse panel apply of the per-call matvec kernels B1 and B5
// (bs_matvec.cu), FP32 FMA for sm_90a. The tensor-core panel product of the
// chain kernels (bs_panel_tc.cuh) and the probes' tile product (bf16x3.cuh)
// take their geometry, window clamp, diagonal and fixed-order sums from
// here.
//
// On the RCM-permuted sector vector padded to multiples of 128, u[ddp, dup]
// (f32), a block computes one 64 x 64 output tile of
//   H u = (A B) o u + H_dw,p u + u H_up,p
// with the dw hops as banded row slabs dw[ntd, 128, W_dw] (panel i of rows
// times a window of W_dw rows of u starting at tile clamp(i - d_dw, 0,
// (ddp - W_dw)/128)) and the up hops as banded column slabs up[ntu, W_up,
// 128] (a lane window of u starting at clamp((j - d_up) * 128, 0,
// dup - W_up) times column panel j's slab). The window clamps are those of
// the JAX package's blocksparse.py:579 and :597.
//
// A window is walked as RUNS: half-open ranges [t0, t1) of 128-tiles,
// relative to the clamped window start, in ascending order. B1b and B5
// pass one run covering the whole window; B1a passes the runs of the
// window's nonzero tiles, skipping the all-zero ones.
// A skipped tile only ever adds fmaf(0, x, acc) == acc, and every output
// element sees the remaining products in the same ascending order, so the
// trimmed and the whole-window products agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // contraction depth per shared-memory stage
constexpr int NT = 256;       // threads per block (16 x 16, 4 x 4 outputs each)
constexpr int FIN_NT = 256;   // threads of a finish kernel

struct Geo {
  int ddp, dup, rank, w_dw, d_dw, w_up, d_up;
};

bool geo_ok(const Geo& g) {
  return g.ddp > 0 && g.dup > 0 && g.ddp % 128 == 0 && g.dup % 128 == 0
         && g.w_dw % 128 == 0 && g.w_up % 128 == 0 && g.w_dw > 0
         && g.w_up > 0 && g.w_dw <= g.ddp && g.w_up <= g.dup && g.rank > 0;
}

// acc[4][4] += A[BM x K] * B[K x BN], both row-major (lda, ldb in floats).
// Every row start and every k0 is a multiple of 4 floats, so the global
// reads are float4.
__device__ __forceinline__ void gemm_acc(float acc[4][4],
                                         const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb,
                                         int K, float (*As)[BM],
                                         float (*Bs)[BN]) {
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int am = t / 4, ak = (t % 4) * 4;     // A tile: 64 rows x 16 k
  const int bk = t / 16, bn = (t % 16) * 4;   // B tile: 16 k x 64 columns
  for (int k0 = 0; k0 < K; k0 += BK) {
    const float4 a = *reinterpret_cast<const float4*>(
        A + (size_t)am * lda + k0 + ak);
    const float4 b = *reinterpret_cast<const float4*>(
        B + (size_t)(k0 + bk) * ldb + bn);
    As[ak + 0][am] = a.x;
    As[ak + 1][am] = a.y;
    As[ak + 2][am] = a.z;
    As[ak + 3][am] = a.w;
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = b;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// First row of the dw window of row panel i: the op's window clamp.
__device__ __forceinline__ int dw_window_base(const Geo& g, int i) {
  return min(max(i - g.d_dw, 0), (g.ddp - g.w_dw) / 128) * 128;
}

// The shared panel apply: acc = (H_p u)[r0:r0+64, c0:c0+64] without the
// diagonal term (added in the epilogue, where u is read anyway), over the
// runs dw_runs[0 .. 2 n_dw) of dw panel r0/128 and up_runs[0 .. 2 n_up) of
// up panel c0/128 (pairs t0, t1 in 128-tile units of the window). The dw
// window is the W_dw rows of u_dw from row `base` on; the up contraction
// reads u's rows r0.. . The single-vector kernels pass u_dw = u and
// base = dw_window_base(g, r0 / 128); the dw-sharded kernel passes its
// halo'd rows and a per-panel start from its table.
__device__ __forceinline__ void hop_tile(float acc[4][4],
                                         const float* __restrict__ dw,
                                         const float* __restrict__ up,
                                         const float* __restrict__ u_dw,
                                         int base,
                                         const float* __restrict__ u,
                                         const Geo& g, int r0, int c0,
                                         const int* __restrict__ dw_runs,
                                         int n_dw,
                                         const int* __restrict__ up_runs,
                                         int n_up) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int i = r0 / 128, j = c0 / 128;
  const int s_up = min(max((j - g.d_up) * 128, 0), g.dup - g.w_up);
  // dw hops: dw slab rows [64 x W_dw] times u_dw rows base..base+W_dw
  const float* dw_rows = dw + ((size_t)i * 128 + (r0 % 128)) * g.w_dw;
  for (int q = 0; q < n_dw; ++q) {
    const int k0 = dw_runs[2 * q] * 128, k1 = dw_runs[2 * q + 1] * 128;
    gemm_acc(acc, dw_rows + k0, g.w_dw,
             u_dw + (size_t)(base + k0) * g.dup + c0, g.dup, k1 - k0, As, Bs);
  }
  // up hops: u lane window [64 x W_up] times up slab j columns
  const float* up_cols = up + (size_t)j * g.w_up * 128 + (c0 % 128);
  for (int q = 0; q < n_up; ++q) {
    const int k0 = up_runs[2 * q] * 128, k1 = up_runs[2 * q + 1] * 128;
    gemm_acc(acc, u + (size_t)r0 * g.dup + s_up + k0, g.dup,
             up_cols + (size_t)k0 * 128, 128, k1 - k0, As, Bs);
  }
}

// separable diagonal (A B)[r, c..c+3]
__device__ __forceinline__ void diag4(float d[4],
                                      const float* __restrict__ da,
                                      const float* __restrict__ db,
                                      const Geo& g, int r, int c) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  for (int q = 0; q < g.rank; ++q) {
    const float a = da[(size_t)r * g.rank + q];
    const float4 b = *reinterpret_cast<const float4*>(db + (size_t)q * g.dup + c);
    d[0] = fmaf(a, b.x, d[0]);
    d[1] = fmaf(a, b.y, d[1]);
    d[2] = fmaf(a, b.z, d[2]);
    d[3] = fmaf(a, b.w, d[3]);
  }
}

// block sum of one double per thread, written by thread 0 to *out
__device__ __forceinline__ void block_sum_store(double v, double* out) {
  __shared__ double red[NT];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

// fixed-order sum of the n doubles at p by one block of FIN_NT threads
// (every thread gets the result)
__device__ __forceinline__ double fixed_order_sum(const double* __restrict__ p,
                                                  int n) {
  __shared__ double red[FIN_NT];
  double s = 0.0;
  for (int q = threadIdx.x; q < n; q += FIN_NT) s += p[q];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = FIN_NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  return red[0];
}

}  // namespace
