// The geometry of the band-sparse panel apply, shared by the tensor-core
// panel product (bs_panel_tc.cuh: the chain kernels B2-B4 and the per-call
// matvec kernels B1, B5) and by the probes' tile product (bf16x3.cuh): the
// sector geometry, the dw window clamp, the separable diagonal and a
// fixed-order sum.
//
// On the RCM-permuted sector vector padded to multiples of 128, u[ddp, dup]
// (f32), the panel apply is
//   H u = (A B) o u + H_dw,p u + u H_up,p
// with the dw hops as banded row slabs dw[ntd, 128, W_dw] (panel i of rows
// times a window of W_dw rows of u starting at tile clamp(i - d_dw, 0,
// (ddp - W_dw)/128)) and the up hops as banded column slabs up[ntu, W_up,
// 128] (a lane window of u starting at clamp((j - d_up) * 128, 0,
// dup - W_up) times column panel j's slab). The window clamps are those of
// the JAX package's blocksparse.py:579 and :597.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FIN_NT = 256;   // threads of a finish kernel

struct Geo {
  int ddp, dup, rank, w_dw, d_dw, w_up, d_up;
};

bool geo_ok(const Geo& g) {
  return g.ddp > 0 && g.dup > 0 && g.ddp % 128 == 0 && g.dup % 128 == 0
         && g.w_dw % 128 == 0 && g.w_up % 128 == 0 && g.w_dw > 0
         && g.w_up > 0 && g.w_dw <= g.ddp && g.w_up <= g.dup && g.rank > 0;
}

// First row of the dw window of row panel i: the op's window clamp.
__device__ __forceinline__ int dw_window_base(const Geo& g, int i) {
  return min(max(i - g.d_dw, 0), (g.ddp - g.w_dw) / 128) * 128;
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
