// The per-call band-sparse sector matvec for Hopper (sm_90a), FP32 FMA.
//
// Replaces the TPU's Pallas kernels of dmft_lanc_ed_tpu/ops/blocksparse.py:
//   B1a  _runs_kernel   -> bs_matvec with the trim runs of the op (the
//                          windows' nonzero 128-tiles), as data
//   B1b  _fused_kernel  -> bs_matvec with one whole-window run per panel
//
// What it computes, on the RCM-permuted sector vector padded to multiples
// of 128, u[ddp, dup] (f32), and a device scalar s (f32):
//   y = s ((A B) o u + H_dw,p u + u H_up,p)          (f32, [ddp, dup])
//   ss[p] = sum of y^2 over the 128-row panel p      (f32, [ntd])
// with the panel apply of bs_panel.cuh. ss feeds the fused normalization
// of a power chain: rsqrt(sum ss) is the next step's s, with no host sync.
//
// The TPU kernel B1a unrolled its panels in Python with the runs as
// compile-time constants (one executable per sector). Here the runs are a
// small int32 table per panel, read by every block of that panel: one
// build serves every sector, and the whole-window form B1b is the same
// kernel given one run per panel. The output tiles are 64 wide, so both
// 64-row (and 64-column) halves of a 128-panel walk that panel's runs.
// Skipped tiles are exact zeros, so trimmed and whole-window outputs agree
// bit for bit (bs_panel.cuh); pad rows and columns of y are exactly 0
// because the slabs' pad rows/columns and u's pad are exactly 0.
//
// Blocks run in no order, so the panel sums of squares are two launches:
// every block writes the f64 sum of its 64 x 64 tile, and a one-block-per-
// panel finish kernel adds a panel's partials in a fixed order (no float
// atomics), so reruns are bit-identical.
//
// What bounds it. At the 854k-state (6,6) sector of nbath = 11
// (ddp = dup = 1024, W_dw = W_up = 640) the whole-window product is
// 2 * 1024^2 * 1280 = 2.7 GFLOP; the trimmed one skips the windows' zero
// tiles. u, y (8 MB) and the slabs (5.2 MB) fit in the 50 MB L2, so the
// call is bound by FP32 operations: the same shared-memory-tiled FMA
// product as the chain kernels. Tensor cores are later work.
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel.cuh"

namespace {

__global__ void __launch_bounds__(NT)
matvec_tile(const float* __restrict__ dw, const float* __restrict__ up,
            const float* __restrict__ da, const float* __restrict__ db,
            const float* __restrict__ u, float* __restrict__ y,
            const float* __restrict__ scale, double* __restrict__ partials,
            const int* __restrict__ dw_ptr, const int* __restrict__ dw_tab,
            const int* __restrict__ up_ptr, const int* __restrict__ up_tab,
            Geo g) {
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int i = r0 / 128, j = c0 / 128;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  hop_tile(acc, dw, up, u, g, r0, c0, dw_tab + 2 * dw_ptr[i],
           dw_ptr[i + 1] - dw_ptr[i], up_tab + 2 * up_ptr[j],
           up_ptr[j + 1] - up_ptr[j]);

  const float s = *scale;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c4 = c0 + tx * 4;
  double part = 0.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty * 4 + a;
    const size_t off = (size_t)r * g.dup + c4;
    const float4 uc = *reinterpret_cast<const float4*>(u + off);
    float d[4];
    diag4(d, da, db, g, r, c4);
    const float ucv[4] = {uc.x, uc.y, uc.z, uc.w};
    float yv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      yv[b] = s * fmaf(d[b], ucv[b], acc[a][b]);
      part += (double)yv[b] * (double)yv[b];
    }
    *reinterpret_cast<float4*>(y + off) = make_float4(yv[0], yv[1], yv[2],
                                                      yv[3]);
  }
  block_sum_store(part, partials + blockIdx.y * gridDim.x + blockIdx.x);
}

// block p: ss[p] = fixed-order sum of the partials of panel p, which are
// the n consecutive entries of its two 64-row block rows
__global__ void finish_panel_ss(const double* __restrict__ partials, int n,
                                float* __restrict__ ss) {
  const double v = fixed_order_sum(partials + (size_t)blockIdx.x * n, n);
  if (threadIdx.x == 0) ss[blockIdx.x] = (float)v;
}

}  // namespace

extern "C" {

// number of per-tile partial sums a call writes (size of `partials`)
int bs_matvec_nblk(int ddp, int dup) { return (ddp / BM) * (dup / BN); }

// One matvec. u, y [ddp, dup] f32 (distinct); scale [1] f32; partials
// [bs_matvec_nblk] f64 scratch; ss [ddp / 128] f32. Runs: dw_ptr [ntd + 1]
// and up_ptr [ntu + 1] int32 offsets into the pair tables dw_tab, up_tab
// (int32 t0, t1 pairs, 128-tile units of the window, ascending, within
// [0, W / 128]).
int bs_matvec(const void* dw, const void* up, const void* da, const void* db,
              const void* u, void* y, const void* scale, void* partials,
              void* ss, const void* dw_ptr, const void* dw_tab,
              const void* up_ptr, const void* up_tab, int ddp, int dup,
              int rank, int w_dw, int d_dw, int w_up, int d_up,
              void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!geo_ok(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(dup / BN, ddp / BM);
  auto* pa = static_cast<double*>(partials);
  matvec_tile<<<grid, NT, 0, s>>>(
      static_cast<const float*>(dw), static_cast<const float*>(up),
      static_cast<const float*>(da), static_cast<const float*>(db),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<const float*>(scale), pa, static_cast<const int*>(dw_ptr),
      static_cast<const int*>(dw_tab), static_cast<const int*>(up_ptr),
      static_cast<const int*>(up_tab), g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a 128-row panel is 2 block rows of dup / BN tiles each
  finish_panel_ss<<<ddp / 128, FIN_NT, 0, s>>>(pa, 2 * (dup / BN),
                                               static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

}  // extern "C"
