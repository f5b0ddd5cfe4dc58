// The zero-tile trim probe's matvec kernels for Hopper (sm_90a), split-bf16
// three-pass products on the tensor cores (bf16x3.cuh).
//
// Replaces the TPU's Pallas kernels of experiments/trim_ab.py:
//   E2a  make_variant.kernel      -> trim_matvec with per-panel tile LISTS
//                                    (cnt [nt], lst [nt, W / 128] int32 per
//                                    side); the probe's four modes
//                                    (untrimmed / dwtrim / uptrim / both)
//                                    pass the whole window or the nonzero
//                                    tiles per side
//   E2b  make_static_runs.kernel  -> trim_matvec with the op's trim RUNS
//                                    (offsets [nt + 1], (t0, t1) pairs), the
//                                    tables B1a reads
//
// What they compute, on the RCM-permuted padded f32 vector u[ddp, dup] and
// a device scalar s: B1's function with split-bf16 products,
//   y = s ((A B) o u + H_dw,p u + u H_up,p),  ss[p] = sum over panel p of y^2
// Every form walks its window tiles in ascending order through one tile
// product, and a tile it skips is all zero, so all five forms give the
// same bits (bf16x3.cuh).
//
// What bounds it. At the 854k-state (6,6) sector of nbath = 11 (1024^2
// padded, W_dw = W_up = 640) the nonzero tiles need 3 x ~1.95 GFLOP of
// bf16 tensor-core products, ~5.9 us at 989 TFLOP/s, against ~12 MB of
// u, y and slab tiles, ~3.6 us at 3.35 TB/s: operations bound it. The
// design is the simple one (WMMA fragments, one synchronous shared-memory
// stage, no wgmma or TMA): it measures whether the three bf16 passes on
// the tensor cores beat the FP32 FMA apply of B1 at all.
//
// The panel sums of squares are two launches, as in bs_matvec.cu: every
// block writes the f64 sum of its tile, and a one-block-per-panel finish
// kernel adds a panel's partials in a fixed order (no float atomics).
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bf16x3.cuh"

namespace {

// the tile lists of panel p: kind 0 = (cnt [nt], lst [nt, ntw]) lists,
// kind 1 = (offsets [nt + 1], pairs [n, 2]) runs (thread 0 only)
__device__ void fill_tiles(int* t, int& n, int kind,
                           const int* __restrict__ a,
                           const int* __restrict__ b, int p, int ntw) {
  n = 0;
  if (kind == 0) {
    const int cnt = min(a[p], ntw);
    for (int q = 0; q < cnt; ++q) t[n++] = b[(size_t)p * ntw + q];
  } else {
    for (int q = a[p]; q < a[p + 1]; ++q)
      for (int w = b[2 * q]; w < b[2 * q + 1] && n < ntw; ++w) t[n++] = w;
  }
}

__global__ void __launch_bounds__(TC_NT)
trim_matvec_tile(const bf16* __restrict__ dw_hi,
                 const bf16* __restrict__ dw_lo,
                 const bf16* __restrict__ up_hi,
                 const bf16* __restrict__ up_lo,
                 const float* __restrict__ da, const float* __restrict__ db,
                 const float* __restrict__ u, float* __restrict__ y,
                 const float* __restrict__ scale,
                 double* __restrict__ partials, int kind,
                 const int* __restrict__ dw_a, const int* __restrict__ dw_b,
                 const int* __restrict__ up_a, const int* __restrict__ up_b,
                 Geo g) {
  __shared__ TileSmem sm;
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  if (threadIdx.x == 0) {
    fill_tiles(sm.dw_t, sm.n_dw, kind, dw_a, dw_b, r0 / 128, g.w_dw / 128);
    fill_tiles(sm.up_t, sm.n_up, kind, up_a, up_b, c0 / 128, g.w_up / 128);
  }
  __syncthreads();
  const Plane pu{u, nullptr, nullptr};
  hop_tile_tc<3, false>(sm, dw_hi, dw_lo, up_hi, up_lo, pu, g, r0, c0);

  const float s = *scale;
  double part = 0.0;
#pragma unroll
  for (int it = 0; it < 8; ++it) {            // 64 x 16 float4 of the tile
    const int idx = it * TC_NT + threadIdx.x;
    const int rr = idx / 16, cc = (idx % 16) * 4;
    const int r = r0 + rr, c = c0 + cc;
    const size_t off = (size_t)r * g.dup + c;
    const float4 uc = *reinterpret_cast<const float4*>(u + off);
    const float4 hc = *reinterpret_cast<const float4*>(&sm.u.c[rr][cc]);
    float d[4];
    diag4(d, da, db, g, r, c);
    float4 yv;
    yv.x = s * fmaf(d[0], uc.x, hc.x);
    yv.y = s * fmaf(d[1], uc.y, hc.y);
    yv.z = s * fmaf(d[2], uc.z, hc.z);
    yv.w = s * fmaf(d[3], uc.w, hc.w);
    part += (double)yv.x * yv.x + (double)yv.y * yv.y
            + (double)yv.z * yv.z + (double)yv.w * yv.w;
    *reinterpret_cast<float4*>(y + off) = yv;
  }
  const double tot = tile_block_sum(sm, part);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

// block p: ss[p] = fixed-order sum of the partials of panel p, the n
// consecutive entries of its two 64-row block rows
__global__ void trim_finish_ss(const double* __restrict__ partials, int n,
                               float* __restrict__ ss) {
  const double v = fixed_order_sum(partials + (size_t)blockIdx.x * n, n);
  if (threadIdx.x == 0) ss[blockIdx.x] = (float)v;
}

}  // namespace

extern "C" {

// number of per-tile partial sums a call writes (size of `partials`)
int trim_matvec_nblk(int ddp, int dup) { return (ddp / TM) * (dup / TN); }

// One matvec (E2a: kind 0, E2b: kind 1). dw_hi/dw_lo [ntd, 128, w_dw] and
// up_hi/up_lo [ntu, w_up, 128] bf16; da [ddp, rank], db [rank, dup] f32;
// u, y [ddp, dup] f32 (distinct); scale [1] f32; partials
// [trim_matvec_nblk] f64 scratch; ss [ddp / 128] f32. Tables, int32, per
// side: kind 0 cnt [nt] and lst [nt, w / 128] (tile indices of the
// window, ascending); kind 1 offsets [nt + 1] and (t0, t1) pairs (the
// runs, ascending, within [0, w / 128]).
int trim_matvec(const void* dw_hi, const void* dw_lo, const void* up_hi,
                const void* up_lo, const void* da, const void* db,
                const void* u, void* y, const void* scale, void* partials,
                void* ss, int kind, const void* dw_a, const void* dw_b,
                const void* up_a, const void* up_b, int ddp, int dup,
                int rank, int w_dw, int d_dw, int w_up, int d_up,
                void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!tc_geo_ok(g) || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(dup / TN, ddp / TM);
  auto* pa = static_cast<double*>(partials);
  trim_matvec_tile<<<grid, TC_NT, 0, s>>>(
      static_cast<const bf16*>(dw_hi), static_cast<const bf16*>(dw_lo),
      static_cast<const bf16*>(up_hi), static_cast<const bf16*>(up_lo),
      static_cast<const float*>(da), static_cast<const float*>(db),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<const float*>(scale), pa, kind,
      static_cast<const int*>(dw_a), static_cast<const int*>(dw_b),
      static_cast<const int*>(up_a), static_cast<const int*>(up_b), g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  trim_finish_ss<<<ddp / 128, FIN_NT, 0, s>>>(pa, 2 * (dup / TN),
                                              static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

}  // extern "C"
