// The chain-breakdown probe's Lanczos chain for Hopper (sm_90a): B2's step
// with the split-bf16 panel product of bf16x3.cuh on the tensor cores, in
// the product forms the probe times.
//
// Replaces the TPU's Pallas kernel of experiments/chain_breakdown.py:
//   E3  make_variant.kernel  -> bd_chain, mode
//     0 3pass     hi.hi + lo.hi + hi.lo per tile (the TPU chain's product)
//     1 1pass     hi.hi alone (the matrix unit's share)
//     2 bf16pair  the two vector planes stored as bf16 hi/lo pairs: window
//                 reads feed the product without a split, every write splits
//     3 nop1      pass 1's write-back skipped (its dot kept)
//     4 tileskip  3pass over the windows' nonzero tiles only (per-tile masks)
//
// One step, on the RCM-permuted padded vector planes (B2's recurrence, the
// JAX kernel's arithmetic: the dot of pass 0 is taken before the coupling):
//   pass 0:  y = s_cur H u_cur; partials <u_cur, y>;
//            plane prv = y - coup prv (y at step 0)
//   finish:  alpha = s_cur <u_cur, y>,  co = alpha s_cur
//   pass 1:  w = prv - co u_cur -> plane prv (not in nop1), partials |w|^2
//   finish:  beta = |w|, coup = beta s_cur, s_cur = 1/beta (0 at breakdown)
// Every step is four launches on one stream (the chain kernels' form before
// their tensor-core redesign), the cross-block sums are f64 partials
// reduced in a fixed order by one-block finish kernels (no float atomics)
// and the scalar state is a small f64 device buffer. The JAX kernel
// carries its state in f32 SMEM scalars; the port's plain version carries
// it in f64, as this kernel does.
//
// What bounds it. A step is one H u (3 x ~1.95 GFLOP of bf16 tensor-core
// products over the nonzero tiles at the 854k-state (6,6) sector, ~5.9 us
// at 989 TFLOP/s; 1pass a third) plus a few passes over the two 4 MB
// planes, which stay in the 50 MB L2: operations bound it.
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bf16x3.cuh"

namespace {

// per-chain scalar state (double)
constexpr int S_CUR = 0;      // inverse norm of the vector in plane cur
constexpr int COUP = 1;       // coefficient of u_prv in pass 0
constexpr int CO = 2;         // coefficient of u_cur in pass 1
constexpr int NSTATE = 4;

enum Mode { M3PASS = 0, M1PASS = 1, MPAIR = 2, MNOP1 = 3, MSKIP = 4 };

// the vector planes: f32 [2, ddp, dup], or bf16 hi and lo [2, ddp, dup]
struct Planes {
  float* f;
  bf16* hi;
  bf16* lo;
};

template <bool PAIR>
__device__ __forceinline__ float4 read4(const Planes& p, size_t off) {
  if (!PAIR) return *reinterpret_cast<const float4*>(p.f + off);
  const uint2 h = *reinterpret_cast<const uint2*>(p.hi + off);
  const uint2 l = *reinterpret_cast<const uint2*>(p.lo + off);
  const __nv_bfloat162* hh = reinterpret_cast<const __nv_bfloat162*>(&h);
  const __nv_bfloat162* ll = reinterpret_cast<const __nv_bfloat162*>(&l);
  const float2 h0 = __bfloat1622float2(hh[0]), h1 = __bfloat1622float2(hh[1]);
  const float2 l0 = __bfloat1622float2(ll[0]), l1 = __bfloat1622float2(ll[1]);
  return make_float4(h0.x + l0.x, h0.y + l0.y, h1.x + l1.x, h1.y + l1.y);
}

template <bool PAIR>
__device__ __forceinline__ void write4(const Planes& p, size_t off,
                                       float4 w) {
  if (!PAIR) {
    *reinterpret_cast<float4*>(p.f + off) = w;
    return;
  }
  uint2 hi, lo;
  split4(w, hi, lo);
  *reinterpret_cast<uint2*>(p.hi + off) = hi;
  *reinterpret_cast<uint2*>(p.lo + off) = lo;
}

// the window tiles of panel p: every tile, or those whose mask is set
// (thread 0 only)
__device__ void fill_masked(int* t, int& n, const int* __restrict__ mask,
                            int p, int ntw) {
  n = 0;
  for (int q = 0; q < ntw; ++q)
    if (mask == nullptr || mask[(size_t)p * ntw + q] != 0) t[n++] = q;
}

// pass 0 on the 64 x 64 tile of this block
template <int PASSES, bool PAIR>
__global__ void __launch_bounds__(TC_NT)
bd_pass0(const bf16* __restrict__ dw_hi, const bf16* __restrict__ dw_lo,
         const bf16* __restrict__ up_hi, const bf16* __restrict__ up_lo,
         const float* __restrict__ da, const float* __restrict__ db,
         Planes pl, const int* __restrict__ dw_mask,
         const int* __restrict__ up_mask, const double* __restrict__ state,
         double* __restrict__ partials, Geo g, int cur, int k) {
  __shared__ TileSmem sm;
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  if (threadIdx.x == 0) {
    fill_masked(sm.dw_t, sm.n_dw, dw_mask, r0 / 128, g.w_dw / 128);
    fill_masked(sm.up_t, sm.n_up, up_mask, c0 / 128, g.w_up / 128);
  }
  __syncthreads();
  const size_t plane = (size_t)g.ddp * g.dup;
  const size_t oc = (size_t)cur * plane, op = (size_t)(1 - cur) * plane;
  const Plane u{PAIR ? nullptr : pl.f + oc, PAIR ? pl.hi + oc : nullptr,
                PAIR ? pl.lo + oc : nullptr};
  hop_tile_tc<PASSES, PAIR>(sm, dw_hi, dw_lo, up_hi, up_lo, u, g, r0, c0);

  const float s_cur = (float)state[S_CUR];
  const float coup = (float)state[COUP];
  double part = 0.0;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int idx = it * TC_NT + threadIdx.x;
    const int rr = idx / 16, cc = (idx % 16) * 4;
    const int r = r0 + rr, c = c0 + cc;
    const size_t off = (size_t)r * g.dup + c;
    const float4 uc = read4<PAIR>(pl, oc + off);
    const float4 hc = *reinterpret_cast<const float4*>(&sm.u.c[rr][cc]);
    float d[4];
    diag4(d, da, db, g, r, c);
    const float4 yv = make_float4(s_cur * fmaf(d[0], uc.x, hc.x),
                                  s_cur * fmaf(d[1], uc.y, hc.y),
                                  s_cur * fmaf(d[2], uc.z, hc.z),
                                  s_cur * fmaf(d[3], uc.w, hc.w));
    part += (double)uc.x * yv.x + (double)uc.y * yv.y
            + (double)uc.z * yv.z + (double)uc.w * yv.w;
    float4 w = yv;
    if (k > 0) {
      const float4 q = read4<PAIR>(pl, op + off);
      w.x = yv.x - coup * q.x;
      w.y = yv.y - coup * q.y;
      w.z = yv.z - coup * q.z;
      w.w = yv.w - coup * q.w;
    }
    write4<PAIR>(pl, op + off, w);
  }
  const double tot = tile_block_sum(sm, part);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

// pass 1 on the 64 x 64 tile of this block: w = prv - co cur
template <bool PAIR, bool WRITE>
__global__ void __launch_bounds__(TC_NT)
bd_pass1(Planes pl, const double* __restrict__ state,
         double* __restrict__ partials, Geo g, int cur) {
  __shared__ double red[TC_NT];
  const size_t plane = (size_t)g.ddp * g.dup;
  const size_t oc = (size_t)cur * plane, op = (size_t)(1 - cur) * plane;
  const float co = (float)state[CO];
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  double part = 0.0;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int idx = it * TC_NT + threadIdx.x;
    const size_t off = (size_t)(r0 + idx / 16) * g.dup + c0 + (idx % 16) * 4;
    const float4 uc = read4<PAIR>(pl, oc + off);
    float4 w = read4<PAIR>(pl, op + off);
    w.x -= co * uc.x;
    w.y -= co * uc.y;
    w.z -= co * uc.z;
    w.w -= co * uc.w;
    part += (double)w.x * w.x + (double)w.y * w.y + (double)w.z * w.z
            + (double)w.w * w.w;
    if (WRITE) write4<PAIR>(pl, op + off, w);
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = TC_NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

__global__ void bd_finish_alpha(const double* __restrict__ partials, int nblk,
                                double* __restrict__ state,
                                double* __restrict__ alphas, int k) {
  const double dot = fixed_order_sum(partials, nblk);
  if (threadIdx.x == 0) {
    const double alpha = state[S_CUR] * dot;
    alphas[k] = alpha;
    state[CO] = alpha * state[S_CUR];
  }
}

__global__ void bd_finish_beta(const double* __restrict__ partials, int nblk,
                               double* __restrict__ state,
                               double* __restrict__ betas, int k) {
  const double ss = fixed_order_sum(partials, nblk);
  if (threadIdx.x == 0) {
    const double beta = sqrt(ss);
    betas[k] = beta;
    state[COUP] = beta * state[S_CUR];
    state[S_CUR] = beta > 1e-30 ? 1.0 / beta : 0.0;
  }
}

template <int PASSES, bool PAIR, bool WRITE>
cudaError_t run_chain(const bf16* dw_hi, const bf16* dw_lo, const bf16* up_hi,
                      const bf16* up_lo, const float* da, const float* db,
                      Planes pl, const int* dw_mask, const int* up_mask,
                      double* st, double* pa, double* alphas, double* betas,
                      const Geo& g, int kk, cudaStream_t s) {
  const dim3 grid(g.dup / TN, g.ddp / TM);
  const int nblk = (g.ddp / TM) * (g.dup / TN);
  for (int k = 0; k < kk; ++k) {
    const int cur = k % 2;
    bd_pass0<PASSES, PAIR><<<grid, TC_NT, 0, s>>>(
        dw_hi, dw_lo, up_hi, up_lo, da, db, pl, dw_mask, up_mask, st, pa, g,
        cur, k);
    bd_finish_alpha<<<1, FIN_NT, 0, s>>>(pa, nblk, st, alphas, k);
    bd_pass1<PAIR, WRITE><<<grid, TC_NT, 0, s>>>(pl, st, pa, g, cur);
    bd_finish_beta<<<1, FIN_NT, 0, s>>>(pa, nblk, st, betas, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// number of per-tile partial sums a step writes (size of `partials`)
int bd_chain_nblk(int ddp, int dup) { return (ddp / TM) * (dup / TN); }

// kk Lanczos steps of one chain in product form `mode` (see the top).
// Slabs as trim_matvec's; planes [2, ddp, dup] f32 (plane 0 the normalized
// start, plane 1 zeros), or for bf16pair plane_hi/plane_lo [2, ddp, dup]
// bf16 (plane 0 the split of the start, plane 1 zeros; `planes` unused);
// dw_mask [ntd, w_dw / 128] and up_mask [ntu, w_up / 128] int32 (tileskip;
// null for the whole windows); state [4] f64 = {1, 0, 0, 0}; partials
// [bd_chain_nblk] f64; alphas, betas [kk] f64.
int bd_chain(const void* dw_hi, const void* dw_lo, const void* up_hi,
             const void* up_lo, const void* da, const void* db, void* planes,
             void* plane_hi, void* plane_lo, const void* dw_mask,
             const void* up_mask, void* state, void* partials, void* alphas,
             void* betas, int mode, int ddp, int dup, int rank, int w_dw,
             int d_dw, int w_up, int d_up, int kk, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!tc_geo_ok(g) || kk <= 0 || mode < M3PASS || mode > MSKIP)
    return (int)cudaErrorInvalidValue;
  const bool pair = mode == MPAIR, skip = mode == MSKIP;
  if ((pair && (plane_hi == nullptr || plane_lo == nullptr))
      || (!pair && planes == nullptr)
      || (skip && (dw_mask == nullptr || up_mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Planes pl{static_cast<float*>(planes), static_cast<bf16*>(plane_hi),
                  static_cast<bf16*>(plane_lo)};
  const auto* dh = static_cast<const bf16*>(dw_hi);
  const auto* dl = static_cast<const bf16*>(dw_lo);
  const auto* uh = static_cast<const bf16*>(up_hi);
  const auto* ul = static_cast<const bf16*>(up_lo);
  const auto* fa = static_cast<const float*>(da);
  const auto* fb = static_cast<const float*>(db);
  const int* dm = skip ? static_cast<const int*>(dw_mask) : nullptr;
  const int* um = skip ? static_cast<const int*>(up_mask) : nullptr;
  auto* st = static_cast<double*>(state);
  auto* pa = static_cast<double*>(partials);
  auto* al = static_cast<double*>(alphas);
  auto* be = static_cast<double*>(betas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case M1PASS:
      err = run_chain<1, false, true>(dh, dl, uh, ul, fa, fb, pl, dm, um, st,
                                      pa, al, be, g, kk, s);
      break;
    case MPAIR:
      err = run_chain<3, true, true>(dh, dl, uh, ul, fa, fb, pl, dm, um, st,
                                     pa, al, be, g, kk, s);
      break;
    case MNOP1:
      err = run_chain<3, false, false>(dh, dl, uh, ul, fa, fb, pl, dm, um,
                                       st, pa, al, be, g, kk, s);
      break;
    default:                                  // 3pass, tileskip
      err = run_chain<3, false, true>(dh, dl, uh, ul, fa, fb, pl, dm, um, st,
                                      pa, al, be, g, kk, s);
  }
  return (int)err;
}

}  // extern "C"
