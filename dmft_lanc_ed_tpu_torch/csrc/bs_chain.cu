// The batched GF Lanczos chain kernel B4 for Hopper (sm_90a), FP32 FMA.
//
// Replaces the TPU's Pallas chain kernel of dmft_lanc_ed_tpu/ops/bs_chain.py:
//   B4  _gf_tridiag_kernel  -> bs_tridiag_chain (a batch of chains, the
//                              chain index is grid dimension z)
// B2 and B3 (_tridiag_kernel, _cheb_kernel) ran on this file's product too
// until they moved to the tensor cores (bs_chain_tc.cu); B4 alone is served
// here, because its contract is ~1e-7 per matvec and the tensor-core
// kernels carry the split-bf16 ~1.5e-5.
//
// What it computes, on the RCM-permuted sector vector padded to multiples
// of 128, u[ddp, dup] (f32):
//   H u = (A B) o u + H_dw,p u + u H_up,p
// through the panel apply of bs_panel.cuh (the banded slabs, their window
// clamps, bs_chain.py:138 and :163), over the whole windows.
//
// K plain Lanczos steps (no reorthogonalization) with lazy normalization:
// vectors are stored unnormalized and their inverse norms ride as scalars.
// One step is
//   pass 0:  y = s_cur H u_cur - coup u_prv   -> plane prv, partials <u_cur,y>
//   finish:  alpha = s_cur <u_cur, y>,  co = alpha s_cur
//   pass 1:  w = y - co u_cur                  -> plane prv, partials |w|^2
//   finish:  beta = |w|, coup = beta s_cur, s_cur = 1/beta (0 at breakdown)
//
// Hopper runs blocks in no order, so the TPU kernel's sequential grid with
// its sums carried in SMEM becomes separate launches: every step is four
// kernels launched back to back on one stream, the host never synchronizes
// inside a chain, and each cross-block sum is reduced by a one-block finish
// kernel in a fixed order (no float atomics), so reruns are bit-identical.
// The scalar state lives in a small device buffer.
//
// What bounds it. At the 854k-state (6,6) sector of nbath = 11
// (ddp = dup = 1024, W_dw = W_up = 640), one H u is 2 * 1024^2 * 1280 =
// 2.7 GFLOP of banded f32 product (1.34 dw + 1.34 up). The two vector
// planes (8 MB a chain) and the f32 slabs (5.2 MB) fit in the 50 MB L2 of
// an H100 (NVIDIA data sheet), so a step is bound by FP32 operations, not
// device memory. The design answers that with a plain shared-memory-tiled
// FP32 FMA product (64 x 64 output tile per block, 4 x 4 outputs per
// thread, f32 accumulation over the f32 slabs) at full f32 fidelity. The
// folded finish kernels and the pipelined staging of bs_chain_tc.cu, and a
// tensor-core product that keeps ~1e-7 (3xTF32, or the split-bf16 one if
// its error proves small enough for G), are later work for B4.
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel.cuh"

namespace {

// per-chain scalar state (double)
constexpr int S_CUR = 0;      // inverse norm of the vector in plane cur
constexpr int COUP = 1;       // coefficient of u_prv (tridiag)
constexpr int CO = 2;         // coefficient of u_cur in pass 1 (tridiag)
constexpr int NSTATE = 4;     // slots a chain (the 4th is unused here)

// Lanczos pass 0: y in plane prv, partials of <u_cur, y>
__global__ void __launch_bounds__(NT)
panel_step(const float* __restrict__ dw, const float* __restrict__ up,
           const float* __restrict__ da, const float* __restrict__ db,
           float* __restrict__ planes, const double* __restrict__ state,
           double* __restrict__ partials, Geo g, int cur) {
  const int b = blockIdx.z;
  const size_t plane = (size_t)g.ddp * g.dup;
  const float* u = planes + ((size_t)b * 2 + cur) * plane;
  float* p = planes + ((size_t)b * 2 + (1 - cur)) * plane;
  const double* st = state + (size_t)b * NSTATE;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  hop_tile_full(acc, dw, up, u, g, r0, c0);

  const float f_cur = (float)st[S_CUR];            // y = s_cur Hu - coup u_prv
  const float f_prv = (float)st[COUP];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c4 = c0 + tx * 4;
  double part = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    const size_t off = (size_t)r * g.dup + c4;
    const float4 uc = *reinterpret_cast<const float4*>(u + off);
    const float4 uq = *reinterpret_cast<const float4*>(p + off);
    float d[4];
    diag4(d, da, db, g, r, c4);
    const float ucv[4] = {uc.x, uc.y, uc.z, uc.w};
    const float uqv[4] = {uq.x, uq.y, uq.z, uq.w};
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hu = fmaf(d[j], ucv[j], acc[i][j]);
      y[j] = f_cur * hu - f_prv * uqv[j];
      part += (double)ucv[j] * (double)y[j];
    }
    *reinterpret_cast<float4*>(p + off) = make_float4(y[0], y[1], y[2], y[3]);
  }
  const int nblk = gridDim.x * gridDim.y;
  block_sum_store(part, partials + (size_t)b * nblk
                        + blockIdx.y * gridDim.x + blockIdx.x);
}

// Lanczos pass 1: w = y - co u_cur in plane prv, partials of |w|^2
__global__ void __launch_bounds__(NT)
tridiag_pass1(float* __restrict__ planes, const double* __restrict__ state,
              double* __restrict__ partials, Geo g, int cur) {
  const int b = blockIdx.z;
  const size_t plane = (size_t)g.ddp * g.dup;
  const float* u = planes + ((size_t)b * 2 + cur) * plane;
  float* p = planes + ((size_t)b * 2 + (1 - cur)) * plane;
  const float co = (float)state[(size_t)b * NSTATE + CO];
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  double part = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = (size_t)(r0 + ty * 4 + i) * g.dup + c0 + tx * 4;
    const float4 uc = *reinterpret_cast<const float4*>(u + off);
    float4 w = *reinterpret_cast<const float4*>(p + off);
    w.x -= co * uc.x;
    w.y -= co * uc.y;
    w.z -= co * uc.z;
    w.w -= co * uc.w;
    part += (double)w.x * w.x + (double)w.y * w.y + (double)w.z * w.z
            + (double)w.w * w.w;
    *reinterpret_cast<float4*>(p + off) = w;
  }
  const int nblk = gridDim.x * gridDim.y;
  block_sum_store(part, partials + (size_t)b * nblk
                        + blockIdx.y * gridDim.x + blockIdx.x);
}

__global__ void finish_alpha(const double* __restrict__ partials, int nblk,
                             double* __restrict__ state,
                             double* __restrict__ alphas, int kk, int k) {
  const double dot =
      fixed_order_sum(partials + (size_t)blockIdx.x * nblk, nblk);
  if (threadIdx.x == 0) {
    double* st = state + (size_t)blockIdx.x * NSTATE;
    const double alpha = st[S_CUR] * dot;
    alphas[(size_t)blockIdx.x * kk + k] = alpha;
    st[CO] = alpha * st[S_CUR];
  }
}

__global__ void finish_beta(const double* __restrict__ partials, int nblk,
                            double* __restrict__ state,
                            double* __restrict__ betas, int kk, int k) {
  const double ss =
      fixed_order_sum(partials + (size_t)blockIdx.x * nblk, nblk);
  if (threadIdx.x == 0) {
    double* st = state + (size_t)blockIdx.x * NSTATE;
    const double beta = sqrt(ss);
    betas[(size_t)blockIdx.x * kk + k] = beta;
    st[COUP] = beta * st[S_CUR];
    st[S_CUR] = beta > 1e-30 ? 1.0 / beta : 0.0;
  }
}

}  // namespace

extern "C" {

// number of per-chain partial sums a step writes (size of `partials` / nb)
int bs_chain_nblk(int ddp, int dup) { return (ddp / BM) * (dup / BN); }

// K Lanczos steps for nb independent chains (B4: a batch).
// planes [nb, 2, ddp, dup] f32: plane 0 holds the normalized start vector,
// plane 1 zeros; state [nb, 4] f64 = {1, 0, 0, 0}; partials [nb, nblk] f64;
// alphas, betas [nb, kk] f64.
int bs_tridiag_chain(const void* dw, const void* up, const void* da,
                     const void* db, void* planes, void* state,
                     void* partials, void* alphas, void* betas, int nb,
                     int ddp, int dup, int rank, int w_dw, int d_dw, int w_up,
                     int d_up, int kk, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!geo_ok(g) || nb <= 0 || nb > 65535 || kk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(dup / BN, ddp / BM, nb);
  const int nblk = bs_chain_nblk(ddp, dup);
  auto* pl = static_cast<float*>(planes);
  auto* st = static_cast<double*>(state);
  auto* pa = static_cast<double*>(partials);
  for (int k = 0; k < kk; ++k) {
    const int cur = k % 2;
    panel_step<<<grid, NT, 0, s>>>(
        static_cast<const float*>(dw), static_cast<const float*>(up),
        static_cast<const float*>(da), static_cast<const float*>(db), pl, st,
        pa, g, cur);
    finish_alpha<<<nb, FIN_NT, 0, s>>>(pa, nblk, st,
                                       static_cast<double*>(alphas), kk, k);
    tridiag_pass1<<<grid, NT, 0, s>>>(pl, st, pa, g, cur);
    finish_beta<<<nb, FIN_NT, 0, s>>>(pa, nblk, st,
                                      static_cast<double*>(betas), kk, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
