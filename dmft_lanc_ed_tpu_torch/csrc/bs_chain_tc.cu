// The band-sparse Krylov chain kernels B2 and B3 for Hopper (sm_90a) on the
// tensor cores: the split-bf16 panel product of bs_panel_tc.cuh (wgmma,
// pipelined through a cp.async ring) under B2's and B3's epilogues.
//
// Replaces the TPU's Pallas chain kernels of dmft_lanc_ed_tpu/ops/bs_chain.py:
//   B2  _tridiag_kernel  -> bs_tridiag_chain_tc (one chain)
//   B3  _cheb_kernel     -> bs_cheb_chain_tc
// (B4, the batched GF chain, stays on bs_chain.cu's FP32 FMA product.)
//
// What they compute, on the RCM-permuted sector vector padded to multiples
// of 128, u[ddp, dup]:
//   H u = (A B) o u + H_dw,p u + u H_up,p
// with the hop products in the TPU kernels' own form, three bf16 passes
// hi.hi + lo.hi + hi.lo with f32 accumulation over the whole windows, and
// the separable diagonal, the recurrences and the vectors in f32, the
// cross-block sums and the scalar state in f64 (bs_chain.cu's arithmetic).
// Precision: the split's ~1.5e-5 relative per product, the contract the TPU
// kernels carry; the f32 chain of bs_chain.cu is ~1e-7.
//
// The vectors live as two f32 planes [2, ddp, dup] plus a bf16 hi/lo pair
// of each plane [2, 2, ddp, dup]: the epilogue that writes a vector's final
// f32 value (B2: pass 1; B3: its single pass; the wrapper for the start
// vector) also writes hi = bf16(x), lo = bf16(x - hi), and the products
// read only the pairs. The slabs arrive split, once per op.
//
// One step:
//   B2 pass 0:  y = s_cur H u_cur - coup u_prv -> plane prv; <u_cur, y>
//               last block: alpha = s_cur <u_cur, y>, co = alpha s_cur
//      pass 1:  w = y - co u_cur -> plane prv and its pair; |w|^2
//               last block: beta = |w|, coup = beta s_cur,
//               s_cur = 1/beta (0 at breakdown, beta <= 1e-30)
//   B3:         r = fac (H u_cur - c u_cur) - s_cur s_prv u_prv -> plane prv
//               and its pair, fac = (1 or 2)/e s_cur; |r|^2
//               last block: s_prv = s_cur, s_cur = 1/|r|
//
// What bounds a step on this card and what the design does about it. The
// planes, pairs and split slabs (26 MB at the 854k-state (6,6) sector of
// nbath = 11) stay in the 50 MB L2, so the tensor-core operations bound it
// (3 x 2.7 GFLOP, 8 us at 989 TFLOP/s); below that, what a step pays is
// staging latency and launches. bs_panel_tc.cuh answers the first. For the
// second, a B2 step is two launches and a B3 step one, instead of four and
// two: every block writes its f64 partial, fences, and takes a ticket from
// an atomicAdd on an int counter; the block that draws the last ticket sums
// the partials in a fixed order, updates the scalar state and resets the
// counter. The sum's order does not depend on which block does it, so
// reruns are bit-identical, and there are no float atomics. The next launch
// on the stream sees the state.
//
// The output tile. The launcher picks it from ddp, dup and the SM count: the
// narrowest of 64 x 32, 64 x 64, 64 x 128 whose tiles all fit on the card at
// once at two blocks an SM, else 64 x 128. Most sectors of an nbath = 11 run
// are small (a 220 x 495 sector pads to 256 x 512: 64 tiles of 64 x 32), and
// there a step is latency: narrow tiles spread the staging and the epilogue
// over more SMs, and two blocks an SM hide one's prologue and epilogue under
// the other's products. Wide tiles only pay where the grid needs several
// waves anyway (they move fewer bytes from L2 per product).
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel_tc.cuh"

namespace {

// per-chain scalar state (double), as bs_chain.cu
constexpr int S_CUR = 0;      // inverse norm of the vector in plane cur
constexpr int COUP = 1;       // coefficient of u_prv (tridiag)
constexpr int CO = 2;         // coefficient of u_cur in pass 1 (tridiag)
constexpr int S_PRV = 3;      // inverse norm of the vector in plane prv (cheb)
constexpr int P1_NT = 256;    // threads of a pass-1 block (a 64 x 64 tile)

// Sum of one double per thread over the NTHR threads of the block, then the
// cross-block sum by the last block to arrive: returns true in every thread
// of that block, with the fixed-order total of all nblk partials in *total.
template <int NTHR>
__device__ __forceinline__ bool last_block_sum(double v, double* partials,
                                               unsigned* counter, int blk,
                                               int nblk, double* total) {
  __shared__ double red[NTHR];
  __shared__ bool last;
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = NTHR / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) {
    partials[blk] = red[0];
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned)(nblk - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  double s = 0.0;
  for (int q = t; q < nblk; q += NTHR) s += __ldcg(partials + q);
  red[t] = s;
  __syncthreads();
  for (int h = NTHR / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  *total = red[0];
  if (t == 0) *counter = 0u;
  return true;
}

struct ChainArgs {
  SplitOp op;
  const float *da, *db;         // separable diagonal [ddp, rank], [rank, dup]
  float* planes;                // [2, ddp, dup] f32
  bf16* pair;                   // [2, 2, ddp, dup] bf16: plane, hi/lo
  double* state;                // [4] f64
  double* partials;             // [bs_chain_tc_nblk] f64
  unsigned* counter;            // [1], 0 between launches
  double* out;                  // alphas [kk] (B2) or norm_out [1] (B3)
  Geo g;
};

// MODE 0: Lanczos pass 0 (partials of <u_cur, y>);
// MODE 1: Chebyshev step (partials of |r|^2, the pair of r written).
template <int BN, int MODE>
__global__ void __launch_bounds__(PNT, BN == 128 ? 1 : 2)
tc_step(const ChainArgs a, int cur, float c, float inv_e, int k) {
  extern __shared__ uint8_t ring[];
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  const float* u = a.planes + (size_t)cur * plane;
  float* p = a.planes + (size_t)(1 - cur) * plane;
  const bf16* u_hi = a.pair + (size_t)(2 * cur) * plane;
  const bf16* u_lo = u_hi + plane;
  bf16* p_hi = a.pair + (size_t)(2 * (1 - cur)) * plane;
  bf16* p_lo = p_hi + plane;
  const int r0 = blockIdx.y * PM, c0 = blockIdx.x * BN;

  float acc[BN / 2];
  panel_product<BN>(acc, ring, a.op, u_hi, u_lo, g, r0, c0);

  float f_cur, f_prv, f_c = 0.f;
  if (MODE == 0) {
    f_cur = (float)a.state[S_CUR];                 // y = s_cur Hu - coup u_prv
    f_prv = (float)a.state[COUP];
  } else {
    const double fac = (k == 0 ? (double)inv_e : 2.0 * (double)inv_e)
                       * a.state[S_CUR];
    f_cur = (float)fac;                             // r = fac (Hu - c u)
    f_prv = (float)(a.state[S_CUR] * a.state[S_PRV]);   // - s_cur s_prv u_prv
    f_c = c;
  }
  // this thread's elements: rows ra and ra + 8, column pairs cb + 8 j
  const int t = threadIdx.x;
  const int ra = r0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int cb = c0 + 2 * (t & 3);
  // the separable diagonal (A B)[r, c] of those elements
  float d[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) d[q] = 0.f;
#pragma unroll 8                // rank is a multiple of 8: loads in batches
  for (int q = 0; q < g.rank; ++q) {
    const float a0 = a.da[(size_t)ra * g.rank + q];
    const float a1 = a.da[(size_t)(ra + 8) * g.rank + q];
    const float* brow = a.db + (size_t)q * g.dup + cb;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(brow + 8 * j);
      d[4 * j + 0] = fmaf(a0, b.x, d[4 * j + 0]);
      d[4 * j + 1] = fmaf(a0, b.y, d[4 * j + 1]);
      d[4 * j + 2] = fmaf(a1, b.x, d[4 * j + 2]);
      d[4 * j + 3] = fmaf(a1, b.y, d[4 * j + 3]);
    }
  }
  double part = 0.0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = (size_t)(ra + 8 * h) * g.dup + cb + 8 * j;
      const float2 uc = *reinterpret_cast<const float2*>(u + off);
      const float2 uq = *reinterpret_cast<const float2*>(p + off);
      const float hu0 = fmaf(d[4 * j + 2 * h], uc.x, acc[4 * j + 2 * h]);
      const float hu1 = fmaf(d[4 * j + 2 * h + 1], uc.y,
                             acc[4 * j + 2 * h + 1]);
      float2 y;
      if (MODE == 0) {
        y.x = f_cur * hu0 - f_prv * uq.x;
        y.y = f_cur * hu1 - f_prv * uq.y;
        part += (double)uc.x * (double)y.x + (double)uc.y * (double)y.y;
      } else {
        y.x = f_cur * (hu0 - f_c * uc.x) - f_prv * uq.x;
        y.y = f_cur * (hu1 - f_c * uc.y) - f_prv * uq.y;
        part += (double)y.x * (double)y.x + (double)y.y * (double)y.y;
        __nv_bfloat162 hi, lo;
        split2(y.x, y.y, hi, lo);
        *reinterpret_cast<__nv_bfloat162*>(p_hi + off) = hi;
        *reinterpret_cast<__nv_bfloat162*>(p_lo + off) = lo;
      }
      *reinterpret_cast<float2*>(p + off) = y;
    }
  }
  double tot;
  const int nblk = gridDim.x * gridDim.y;
  if (last_block_sum<PNT>(part, a.partials, a.counter,
                          blockIdx.y * gridDim.x + blockIdx.x, nblk, &tot)
      && t == 0) {
    double* st = a.state;
    if (MODE == 0) {
      const double alpha = st[S_CUR] * tot;
      a.out[k] = alpha;
      st[CO] = alpha * st[S_CUR];
    } else {
      const double nrm = sqrt(tot);
      st[S_PRV] = st[S_CUR];
      st[S_CUR] = nrm > 1e-30 ? 1.0 / nrm : 0.0;
      a.out[0] = nrm;
    }
  }
}

// Lanczos pass 1 on a 64 x 64 tile: w = y - co u_cur in plane prv and its
// pair, partials of |w|^2; the last block writes beta and the state
__global__ void __launch_bounds__(P1_NT)
tc_pass1(const ChainArgs a, double* __restrict__ betas, int cur, int k) {
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  const float* u = a.planes + (size_t)cur * plane;
  float* p = a.planes + (size_t)(1 - cur) * plane;
  bf16* p_hi = a.pair + (size_t)(2 * (1 - cur)) * plane;
  bf16* p_lo = p_hi + plane;
  const float co = (float)a.state[CO];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 64;
  const int t = threadIdx.x;
  double part = 0.0;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * P1_NT + t;
    const size_t off = (size_t)(r0 + idx / 16) * g.dup + c0 + (idx % 16) * 4;
    const float4 uc = *reinterpret_cast<const float4*>(u + off);
    float4 w = *reinterpret_cast<const float4*>(p + off);
    w.x -= co * uc.x;
    w.y -= co * uc.y;
    w.z -= co * uc.z;
    w.w -= co * uc.w;
    part += (double)w.x * w.x + (double)w.y * w.y + (double)w.z * w.z
            + (double)w.w * w.w;
    *reinterpret_cast<float4*>(p + off) = w;
    __nv_bfloat162 h0, l0, h1, l1;
    split2(w.x, w.y, h0, l0);
    split2(w.z, w.w, h1, l1);
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(p_hi + off);
    __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(p_lo + off);
    ph[0] = h0;
    ph[1] = h1;
    pl[0] = l0;
    pl[1] = l1;
  }
  double tot;
  const int nblk = gridDim.x * gridDim.y;
  if (last_block_sum<P1_NT>(part, a.partials, a.counter,
                            blockIdx.y * gridDim.x + blockIdx.x, nblk, &tot)
      && t == 0) {
    double* st = a.state;
    const double beta = sqrt(tot);
    betas[k] = beta;
    st[COUP] = beta * st[S_CUR];
    st[S_CUR] = beta > 1e-30 ? 1.0 / beta : 0.0;
  }
}

// the output tile's width for a ddp x dup grid on a card of `sms` SMs: the
// narrowest of 32, 64, 128 whose tiles are all resident at once (two blocks
// an SM), else 128
int pick_bn(int ddp, int dup, int sms) {
  const int rows = ddp / PM;
  if (rows * (dup / 32) <= 2 * sms) return 32;
  if (rows * (dup / 64) <= 2 * sms) return 64;
  return 128;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  return sms;
}

// a step kernel's dynamic shared memory may exceed the 48 KB default
template <int BN, int MODE>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(tc_step<BN, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Ring<BN>::SMEM_BYTES);
}

template <int BN, int MODE>
void launch_step(const ChainArgs& a, int cur, float c, float inv_e, int k,
                 cudaStream_t s) {
  const dim3 grid(a.g.dup / BN, a.g.ddp / PM);
  tc_step<BN, MODE><<<grid, PNT, Ring<BN>::SMEM_BYTES, s>>>(a, cur, c, inv_e,
                                                            k);
}

template <int MODE>
cudaError_t run_chain(int bn, const ChainArgs& a, double* betas, float c,
                      float inv_e, int kk, cudaStream_t s) {
  cudaError_t err = bn == 128  ? allow_smem<128, MODE>()
                    : bn == 64 ? allow_smem<64, MODE>()
                               : allow_smem<32, MODE>();
  if (err != cudaSuccess) return err;
  const dim3 grid1(a.g.dup / 64, a.g.ddp / 64);
  for (int k = 0; k < kk; ++k) {
    const int cur = k % 2;
    if (bn == 128)
      launch_step<128, MODE>(a, cur, c, inv_e, k, s);
    else if (bn == 64)
      launch_step<64, MODE>(a, cur, c, inv_e, k, s);
    else
      launch_step<32, MODE>(a, cur, c, inv_e, k, s);
    if (MODE == 0) tc_pass1<<<grid1, P1_NT, 0, s>>>(a, betas, cur, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

bool args_ok(const Geo& g, int kk) {
  return geo_ok(g) && g.rank % 8 == 0 && kk > 0;
}

ChainArgs make_args(const void* dw_hi, const void* dw_lo, const void* up_hi,
                    const void* up_lo, const void* da, const void* db,
                    void* planes, void* pair, void* state, void* partials,
                    void* counter, void* out, const Geo& g) {
  return ChainArgs{
      SplitOp{static_cast<const bf16*>(dw_hi), static_cast<const bf16*>(dw_lo),
              static_cast<const bf16*>(up_hi),
              static_cast<const bf16*>(up_lo)},
      static_cast<const float*>(da), static_cast<const float*>(db),
      static_cast<float*>(planes), static_cast<bf16*>(pair),
      static_cast<double*>(state), static_cast<double*>(partials),
      static_cast<unsigned*>(counter), static_cast<double*>(out), g};
}

}  // namespace

extern "C" {

// the most per-block partial sums a step writes (size of `partials`)
int bs_chain_tc_nblk(int ddp, int dup) { return (ddp / PM) * (dup / 32); }

// the output tile's width the launchers take for a ddp x dup grid on the
// current device (0 if the device cannot be read)
int bs_chain_tc_tile(int ddp, int dup) {
  const int sms = sm_count();
  return sms > 0 ? pick_bn(ddp, dup, sms) : 0;
}

// kk Lanczos steps of one chain (B2). dw_hi/dw_lo [ntd, 128, W_dw] and
// up_hi/up_lo [ntu, W_up, 128] bf16: the split slabs; da, db f32; planes
// [2, ddp, dup] f32: plane 0 the normalized start vector, plane 1 zeros;
// pair [2, 2, ddp, dup] bf16: pair[0] the split of the start, pair[1]
// zeros; state [4] f64 = {1, 0, 0, 0}; partials [bs_chain_tc_nblk] f64;
// counter [1] int32 = 0 (left 0); alphas, betas [kk] f64.
int bs_tridiag_chain_tc(const void* dw_hi, const void* dw_lo,
                        const void* up_hi, const void* up_lo, const void* da,
                        const void* db, void* planes, void* pair, void* state,
                        void* partials, void* counter, void* alphas,
                        void* betas, int ddp, int dup, int rank, int w_dw,
                        int d_dw, int w_up, int d_up, int kk, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!args_ok(g, kk)) return (int)cudaErrorInvalidValue;
  const int bn = bs_chain_tc_tile(ddp, dup);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const ChainArgs a = make_args(dw_hi, dw_lo, up_hi, up_lo, da, db, planes,
                                pair, state, partials, counter, alphas, g);
  return (int)run_chain<0>(bn, a, static_cast<double*>(betas), 0.f, 0.f, kk,
                           static_cast<cudaStream_t>(stream));
}

// kk scaled-Chebyshev steps of one chain (B3); arguments as above, norm_out
// [1] f64 receives the last step's norm. The filtered (unnormalized) vector
// ends in plane kk % 2.
int bs_cheb_chain_tc(const void* dw_hi, const void* dw_lo, const void* up_hi,
                     const void* up_lo, const void* da, const void* db,
                     void* planes, void* pair, void* state, void* partials,
                     void* counter, void* norm_out, float c, float inv_e,
                     int ddp, int dup, int rank, int w_dw, int d_dw, int w_up,
                     int d_up, int kk, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!args_ok(g, kk)) return (int)cudaErrorInvalidValue;
  const int bn = bs_chain_tc_tile(ddp, dup);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const ChainArgs a = make_args(dw_hi, dw_lo, up_hi, up_lo, da, db, planes,
                                pair, state, partials, counter, norm_out, g);
  return (int)run_chain<1>(bn, a, nullptr, c, inv_e, kk,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
