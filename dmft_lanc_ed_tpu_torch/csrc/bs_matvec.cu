// The per-call band-sparse sector matvec for Hopper (sm_90a), FP32 FMA.
//
// Replaces the TPU's Pallas kernels of dmft_lanc_ed_tpu/ops/blocksparse.py:
//   B1a  _runs_kernel   -> bs_matvec with the trim runs of the op (the
//                          windows' nonzero 128-tiles), as data
//   B1b  _fused_kernel  -> bs_matvec with one whole-window run per panel
// and of dmft_lanc_ed_tpu/parallel/bs_sharded.py:
//   B5   _local_kernel  -> bs_sharded_matvec: one rank's rows of B1b on a
//                          dw-row-sharded vector (see below)
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
// B5, the dw-sharded form. A rank holds the 128-row panels [d ntl, (d+1)
// ntl) of the vector (u_loc, local rows) and, from the halo exchange, u_ext
// = [last d_dw panels of rank d-1 | u_loc | first d_dw panels of rank d+1]
// (zeros past the ends). The up contraction and the diagonal are local to
// u_loc; the dw window of local panel i starts at row 128 t[i] of u_ext, a
// host table t[i] = clamp(d ntl + i - d_dw) - (d ntl - d_dw), as the JAX
// package's SMEM input (bs_sharded.py:174-180). Only where the window
// starts differs from B1b: the same tiles are multiplied in the same order,
// and no clamped window reaches an edge rank's zero halo, so the ranks'
// outputs stitched together equal B1b's bit for bit. The cross-rank sum of
// the panel sums is a collective outside the kernel. Its bound: each of n
// ranks does 1/n of B1b's operations (FP32, as above).
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel.cuh"

namespace {

// One 64 x 64 tile of y. The dw window of panel i is read from u_dw at row
// 128 t_tab[i] when a window table is given (B5), else from u at the clamp
// (B1; u_dw == u).
__global__ void __launch_bounds__(NT)
matvec_tile(const float* __restrict__ dw, const float* __restrict__ up,
            const float* __restrict__ da, const float* __restrict__ db,
            const float* __restrict__ u, const float* __restrict__ u_dw,
            const int* __restrict__ t_tab, float* __restrict__ y,
            const float* __restrict__ scale, double* __restrict__ partials,
            const int* __restrict__ dw_ptr, const int* __restrict__ dw_tab,
            const int* __restrict__ up_ptr, const int* __restrict__ up_tab,
            Geo g) {
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int i = r0 / 128, j = c0 / 128;
  const int base = t_tab ? t_tab[i] * 128 : dw_window_base(g, i);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  hop_tile(acc, dw, up, u_dw, base, u, g, r0, c0, dw_tab + 2 * dw_ptr[i],
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
      static_cast<const float*>(u), static_cast<const float*>(u), nullptr,
      static_cast<float*>(y), static_cast<const float*>(scale), pa,
      static_cast<const int*>(dw_ptr), static_cast<const int*>(dw_tab),
      static_cast<const int*>(up_ptr), static_cast<const int*>(up_tab), g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a 128-row panel is 2 block rows of dup / BN tiles each
  finish_panel_ss<<<ddp / 128, FIN_NT, 0, s>>>(pa, 2 * (dup / BN),
                                               static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

// B5: one rank's rows. u_loc, y [loc, dup] f32 (distinct); u_ext [ext, dup]
// f32 with ext = loc + 2 * 128 d_dw; dw [loc / 128, 128, w_dw] the rank's
// dw slabs; da [loc, rank] its diagonal rows; t_tab [loc / 128] int32
// window starts in 128-row tiles of u_ext (the caller checks 0 <= 128 t
// and 128 t + w_dw <= ext); scale [1] f32; partials [bs_matvec_nblk(loc,
// dup)] f64 scratch; ss [loc / 128] f32; runs as for bs_matvec, over the
// loc / 128 local dw panels.
int bs_sharded_matvec(const void* dw, const void* up, const void* da,
                      const void* db, const void* u_loc, const void* u_ext,
                      const void* t_tab, void* y, const void* scale,
                      void* partials, void* ss, const void* dw_ptr,
                      const void* dw_tab, const void* up_ptr,
                      const void* up_tab, int loc, int ext, int dup, int rank,
                      int w_dw, int d_dw, int w_up, int d_up, void* stream) {
  const Geo g{loc, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!(loc > 0 && dup > 0 && loc % 128 == 0 && dup % 128 == 0
        && w_dw > 0 && w_dw % 128 == 0 && w_up > 0 && w_up % 128 == 0
        && w_up <= dup && rank > 0 && ext == loc + 2 * 128 * d_dw
        && w_dw <= ext))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(dup / BN, loc / BM);
  auto* pa = static_cast<double*>(partials);
  matvec_tile<<<grid, NT, 0, s>>>(
      static_cast<const float*>(dw), static_cast<const float*>(up),
      static_cast<const float*>(da), static_cast<const float*>(db),
      static_cast<const float*>(u_loc), static_cast<const float*>(u_ext),
      static_cast<const int*>(t_tab), static_cast<float*>(y),
      static_cast<const float*>(scale), pa, static_cast<const int*>(dw_ptr),
      static_cast<const int*>(dw_tab), static_cast<const int*>(up_ptr),
      static_cast<const int*>(up_tab), g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_panel_ss<<<loc / 128, FIN_NT, 0, s>>>(pa, 2 * (dup / BN),
                                               static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

}  // extern "C"
