// The band-sparse Krylov chain kernels B2, B3 and B4 for Hopper (sm_90a) on
// the tensor cores: the split-bf16 panel product of bs_panel_tc.cuh (wgmma,
// pipelined through a cp.async ring) under the chains' epilogues.
//
// Replaces the TPU's Pallas chain kernels of dmft_lanc_ed_tpu/ops/bs_chain.py:
//   B2  _tridiag_kernel     -> bs_tridiag_chain_tc (one chain)
//   B3  _cheb_kernel        -> bs_cheb_chain_tc
//   B4  _gf_tridiag_kernel  -> bs_gf_tridiag_chain_tc (a batch of chains,
//                              the chain index is grid dimension z)
//
// What they compute, on the RCM-permuted sector vector padded to multiples
// of 128, u[ddp, dup]:
//   H u = (A B) o u + H_dw,p u + u H_up,p
// with the hop products in the TPU kernels' own forms, bf16 parts with f32
// accumulation over the whole windows: B2 and B3 three passes over a
// two-part split (~1.5e-5 relative per product, their contract), B4 six
// passes over a three-part split (24 significant bits a side, as Mosaic's
// HIGHEST dots of _gf_tridiag_kernel; the GF chains' ~1e-7 per-matvec
// contract). The separable diagonal, the recurrences and the vectors are
// f32, the cross-block sums and the scalar state f64.
//
// The vectors of a chain live as two f32 planes [2, ddp, dup] plus the P
// bf16 parts of each plane [2, P, ddp, dup]: the epilogue that writes a
// vector's final f32 value (B2/B4: pass 1; B3: its single pass; the wrapper
// for the start vector) also writes its parts, and the products read only
// the parts. The slabs arrive split, once per op.
//
// One step:
//   B2/B4 pass 0:  y = s_cur H u_cur - coup u_prv -> plane prv; <u_cur, y>
//                  last block: alpha = s_cur <u_cur, y>, co = alpha s_cur
//         pass 1:  w = y - co u_cur -> plane prv and its parts; |w|^2
//                  last block: beta = |w|, coup = beta s_cur,
//                  s_cur = 1/beta (0 at breakdown, beta <= 1e-30)
//   B3:            r = fac (H u_cur - c u_cur) - s_cur s_prv u_prv -> plane
//                  prv and its parts, fac = (1 or 2)/e s_cur; |r|^2
//                  last block: s_prv = s_cur, s_cur = 1/|r|
// B4 runs nb chains at once: every chain has its own planes, parts, f64
// state, partial sums and ticket counter, and blockIdx.z picks the chain.
//
// What bounds a step on this card and what the design does about it. The
// planes, parts and split slabs (26 MB at the 854k-state (6,6) sector of
// nbath = 11 for B2, 32 MB a B4 chain) stay in the 50 MB L2, so the
// tensor-core operations bound it (2.0 GFLOP a pass over the nonzero window
// tiles: 6 us at three passes, 12 us at six, at 989 TFLOP/s); below that,
// what a step pays is staging latency, L2-to-SM bytes and launches.
// bs_panel_tc.cuh answers the first. For the last, a B2/B4 step is two
// launches and a B3 step one: every block writes its f64 partial, fences,
// and takes a ticket from an atomicAdd on an int counter; the block that
// draws the last ticket sums the partials in a fixed order, updates the
// scalar state and resets the counter. The sum's order does not depend on
// which block does it, so reruns are bit-identical, and there are no float
// atomics. The next launch on the stream sees the state.
//
// The output tile. The launcher picks it from ddp, dup, the chains and the
// SM count: the narrowest tile whose tiles of all chains are resident at
// once (a B2/B3 ring fits two blocks an SM at 64 x 32 and 64 x 64; a B4 ring
// two at 64 x 32, one at 64 x 128), else 64 x 128. Most sectors of an nbath
// = 11 run are small (a 220 x 495 sector pads to 256 x 512: 64 tiles of 64
// x 32), and there a step is latency: narrow tiles spread the staging and
// the epilogue over more SMs, and two blocks an SM hide one's prologue and
// epilogue under the other's products. Wide tiles only pay where the grid
// needs several waves anyway (they move fewer bytes from L2 per product).
// B4 has no 64 x 64 tile: its 3-stage ring takes 145 KB, one block an SM,
// so 64 x 32 at two blocks covers the same grid with more blocks. A B4
// block of width BN writes BN / 32 partial sums of <u, y>, one per 64 x 32
// sub-tile, summed over the sub-tile's elements in the order a 64 x 32
// block takes: the sums then do not depend on the tile, and a chain run
// with others gives the same bits as run alone.
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel_tc.cuh"

namespace {

// per-chain scalar state (double)
constexpr int S_CUR = 0;      // inverse norm of the vector in plane cur
constexpr int COUP = 1;       // coefficient of u_prv (tridiag)
constexpr int CO = 2;         // coefficient of u_cur in pass 1 (tridiag)
constexpr int S_PRV = 3;      // inverse norm of the vector in plane prv (cheb)
constexpr int NSTATE = 4;     // slots a chain
constexpr int P1_NT = 256;    // threads of a pass-1 block (a 64 x 64 tile)

// modes of the step kernel
constexpr int LANCZOS = 0;    // pass 0 of B2/B4: partials of <u_cur, y>
constexpr int CHEB = 1;       // B3's step: partials of |r|^2, r's parts
constexpr int HV = 2;         // y = H u alone, no sums (tests, measurement)

// partial sums of one chain: a 64 x 32 tile's worth at most
__host__ __device__ size_t partials_per_chain(const Geo& g) {
  return (size_t)(g.ddp / PM) * (g.dup / 32);
}

struct ChainArgs {
  SplitOp op;
  const float *da, *db;         // separable diagonal [ddp, rank], [rank, dup]
  float* planes;                // [nb, 2, ddp, dup] f32
  bf16* parts;                  // [nb, 2, P, ddp, dup] bf16: plane, part
  double* state;                // [nb, NSTATE] f64
  double* partials;             // [nb, partials_per_chain] f64
  unsigned* counter;            // [nb], 0 between launches
  double* out;                  // alphas [nb, kk] (B2/B4) or norm_out [1] (B3)
  int kk;
  Geo g;
};

// One pass-0 step (LANCZOS), Chebyshev step (CHEB) or product (HV) over the
// 64 x BN tile (blockIdx.x, blockIdx.y) of chain blockIdx.z.
template <int BN, int MODE, int P>
__global__ void __launch_bounds__(PNT, (Ring<BN, P>::BLOCKS))
tc_step(const ChainArgs a, int cur, float c, float inv_e, int k) {
  extern __shared__ uint8_t ring[];
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  const int b = blockIdx.z;
  float* planes = a.planes + (size_t)b * 2 * plane;
  bf16* parts = a.parts + (size_t)b * 2 * P * plane;
  const float* u = planes + (size_t)cur * plane;
  float* p = planes + (size_t)(1 - cur) * plane;
  bf16* p_parts = parts + (size_t)(P * (1 - cur)) * plane;
  double* st = a.state + (size_t)b * NSTATE;
  const int r0 = blockIdx.y * PM, c0 = blockIdx.x * BN;

  float acc[BN / 2];
  panel_product<BN, P>(acc, ring, a.op, parts + P * cur * plane,
                                plane, g, r0, c0);

  float f_cur = 1.f, f_prv = 0.f, f_c = 0.f;
  if (MODE == LANCZOS) {
    f_cur = (float)st[S_CUR];                     // y = s_cur Hu - coup u_prv
    f_prv = (float)st[COUP];
  } else if (MODE == CHEB) {
    const double fac = (k == 0 ? (double)inv_e : 2.0 * (double)inv_e)
                       * st[S_CUR];
    f_cur = (float)fac;                             // r = fac (Hu - c u)
    f_prv = (float)(st[S_CUR] * st[S_PRV]);         // - s_cur s_prv u_prv
    f_c = c;
  }
  // this thread's elements: rows ra and ra + 8, column pairs cb + 8 j
  const int t = threadIdx.x;
  const int ra = r0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int cb = c0 + 2 * (t & 3);
  // the separable diagonal (A B)[r, c] of those elements
  float d[BN / 2];
  tile_diag<BN>(d, a.da, a.db, g, ra, cb);
  // B4 (P = 3): one partial per 64 x 32 sub-tile (see the top of the file)
  constexpr int Q = P == 3 ? BN / 32 : 1;
  constexpr int JQ = BN / 8 / Q;
  double part[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) part[q] = 0.0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = (size_t)(ra + 8 * h) * g.dup + cb + 8 * j;
      const float2 uc = *reinterpret_cast<const float2*>(u + off);
      const float hu0 = fmaf(d[4 * j + 2 * h], uc.x, acc[4 * j + 2 * h]);
      const float hu1 = fmaf(d[4 * j + 2 * h + 1], uc.y,
                             acc[4 * j + 2 * h + 1]);
      float2 y;
      if (MODE == LANCZOS) {
        const float2 uq = *reinterpret_cast<const float2*>(p + off);
        y.x = f_cur * hu0 - f_prv * uq.x;
        y.y = f_cur * hu1 - f_prv * uq.y;
        part[j / JQ] += (double)uc.x * (double)y.x
                        + (double)uc.y * (double)y.y;
      } else if (MODE == CHEB) {
        const float2 uq = *reinterpret_cast<const float2*>(p + off);
        y.x = f_cur * (hu0 - f_c * uc.x) - f_prv * uq.x;
        y.y = f_cur * (hu1 - f_c * uc.y) - f_prv * uq.y;
        part[j / JQ] += (double)y.x * (double)y.x
                        + (double)y.y * (double)y.y;
        store_parts<P>(y.x, y.y, p_parts, plane, off);
      } else {
        y.x = hu0;
        y.y = hu1;
      }
      *reinterpret_cast<float2*>(p + off) = y;
    }
  }
  if (MODE == HV) return;
  double tot;
  const int nblk = gridDim.x * gridDim.y;
  if (last_block_sum<PNT, Q>(part, a.partials + b * partials_per_chain(g),
                             a.counter + b,
                             blockIdx.y * gridDim.x + blockIdx.x, nblk,
                             nblk * Q, &tot)
      && t == 0) {
    if (MODE == LANCZOS) {
      const double alpha = st[S_CUR] * tot;
      a.out[(size_t)b * a.kk + k] = alpha;
      st[CO] = alpha * st[S_CUR];
    } else {
      const double nrm = sqrt(tot);
      st[S_PRV] = st[S_CUR];
      st[S_CUR] = nrm > 1e-30 ? 1.0 / nrm : 0.0;
      a.out[0] = nrm;
    }
  }
}

// Lanczos pass 1 on a 64 x 64 tile of chain blockIdx.z: w = y - co u_cur in
// plane prv and its P parts, partials of |w|^2; the last block writes beta
// and the state
template <int P>
__global__ void __launch_bounds__(P1_NT)
tc_pass1(const ChainArgs a, double* __restrict__ betas, int cur, int k) {
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  const int b = blockIdx.z;
  const float* u = a.planes + ((size_t)b * 2 + cur) * plane;
  float* p = a.planes + ((size_t)b * 2 + 1 - cur) * plane;
  bf16* p_parts = a.parts + ((size_t)b * 2 + 1 - cur) * P * plane;
  double* st = a.state + (size_t)b * NSTATE;
  const float co = (float)st[CO];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 64;
  const int t = threadIdx.x;
  double part[1] = {0.0};
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
    part[0] += (double)w.x * w.x + (double)w.y * w.y + (double)w.z * w.z
               + (double)w.w * w.w;
    *reinterpret_cast<float4*>(p + off) = w;
    store_parts<P>(w.x, w.y, p_parts, plane, off);
    store_parts<P>(w.z, w.w, p_parts, plane, off + 2);
  }
  double tot;
  const int nblk = gridDim.x * gridDim.y;
  if (last_block_sum<P1_NT, 1>(part, a.partials + b * partials_per_chain(g),
                               a.counter + b,
                               blockIdx.y * gridDim.x + blockIdx.x, nblk,
                               nblk, &tot)
      && t == 0) {
    const double beta = sqrt(tot);
    betas[(size_t)b * a.kk + k] = beta;
    st[COUP] = beta * st[S_CUR];
    st[S_CUR] = beta > 1e-30 ? 1.0 / beta : 0.0;
  }
}

// the output tile's width for nb chains of `parts` bf16 parts on the
// current device (pick_bn; see the top of the file), 0 if unreadable
int tile_for(int ddp, int dup, int nb, int parts) {
  const int sms = sm_count();
  if (sms <= 0) return 0;
  return parts == 3 ? pick_bn<3>(ddp, dup, nb, sms)
                    : pick_bn<2>(ddp, dup, nb, sms);
}

// Launch one step kernel at tile width bn over nb chains; its dynamic
// shared memory may exceed the 48 KB default.
template <int BN, int MODE, int P>
cudaError_t launch_step(const ChainArgs& a, int nb, int cur, float c,
                        float inv_e, int k, cudaStream_t s) {
  auto* kern = tc_step<BN, MODE, P>;
  if (k == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ring<BN, P>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.g.dup / BN, a.g.ddp / PM, nb);
  kern<<<grid, PNT, Ring<BN, P>::SMEM_BYTES, s>>>(a, cur, c, inv_e, k);
  return cudaSuccess;
}

template <int MODE, int P>
cudaError_t launch_step_bn(int bn, const ChainArgs& a, int nb, int cur,
                           float c, float inv_e, int k, cudaStream_t s) {
  if (bn == 128) return launch_step<128, MODE, P>(a, nb, cur, c, inv_e, k, s);
  if constexpr (P == 2) {
    if (bn == 64) return launch_step<64, MODE, P>(a, nb, cur, c, inv_e, k, s);
  }
  if (bn == 32) return launch_step<32, MODE, P>(a, nb, cur, c, inv_e, k, s);
  return cudaErrorInvalidValue;
}

template <int MODE, int P>
cudaError_t run_chain(int bn, const ChainArgs& a, int nb, double* betas,
                      float c, float inv_e, int kk, cudaStream_t s) {
  const dim3 grid1(a.g.dup / 64, a.g.ddp / 64, nb);
  for (int k = 0; k < kk; ++k) {
    const int cur = k % 2;
    cudaError_t err =
        launch_step_bn<MODE, P>(bn, a, nb, cur, c, inv_e, k, s);
    if (err != cudaSuccess) return err;
    if (MODE == LANCZOS) tc_pass1<P><<<grid1, P1_NT, 0, s>>>(a, betas, cur, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

bool args_ok(const Geo& g, int kk) {
  return geo_ok(g) && g.rank % 8 == 0 && kk > 0;
}

ChainArgs make_args(const void* const* dw, const void* const* up, int parts,
                    const void* da, const void* db, void* planes, void* pv,
                    void* state, void* partials, void* counter, void* out,
                    int kk, const Geo& g) {
  SplitOp op{};
  for (int p = 0; p < parts; ++p) {
    op.dw[p] = static_cast<const bf16*>(dw[p]);
    op.up[p] = static_cast<const bf16*>(up[p]);
  }
  return ChainArgs{op,
                   static_cast<const float*>(da),
                   static_cast<const float*>(db),
                   static_cast<float*>(planes),
                   static_cast<bf16*>(pv),
                   static_cast<double*>(state),
                   static_cast<double*>(partials),
                   static_cast<unsigned*>(counter),
                   static_cast<double*>(out),
                   kk,
                   g};
}

}  // namespace

extern "C" {

// the most per-block partial sums a step of one chain writes (the stride
// of `partials` between chains)
int bs_chain_tc_nblk(int ddp, int dup) { return (ddp / PM) * (dup / 32); }

// the output tile's width the launchers take for nb chains of `parts` bf16
// parts on a ddp x dup grid on the current device (0 if the device cannot
// be read)
int bs_chain_tc_tile(int ddp, int dup, int nb, int parts) {
  return tile_for(ddp, dup, nb, parts);
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
  const int bn = tile_for(ddp, dup, 1, 2);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const void* dw[2] = {dw_hi, dw_lo};
  const void* up[2] = {up_hi, up_lo};
  const ChainArgs a = make_args(dw, up, 2, da, db, planes, pair, state,
                                partials, counter, alphas, kk, g);
  return (int)run_chain<LANCZOS, 2>(bn, a, 1,
                                           static_cast<double*>(betas), 0.f,
                                           0.f, kk,
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
  const int bn = tile_for(ddp, dup, 1, 2);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const void* dw[2] = {dw_hi, dw_lo};
  const void* up[2] = {up_hi, up_lo};
  const ChainArgs a = make_args(dw, up, 2, da, db, planes, pair, state,
                                partials, counter, norm_out, kk, g);
  return (int)run_chain<CHEB, 2>(bn, a, 1, nullptr, c, inv_e, kk,
                                        static_cast<cudaStream_t>(stream));
}

// kk Lanczos steps of nb GF chains at once (B4), six-pass products.
// dw [3] and up [3]: the (hi, mid, lo) parts of the slabs, bf16; da, db
// f32; planes [nb, 2, ddp, dup] f32: plane 0 of each chain its normalized
// start vector, plane 1 zeros; parts [nb, 2, 3, ddp, dup] bf16: parts[:, 0]
// the split of the starts, parts[:, 1] zeros; state [nb, 4] f64 = {1, 0,
// 0, 0} each; partials [nb, bs_chain_tc_nblk] f64; counter [nb] int32 = 0
// (left 0); alphas, betas [nb, kk] f64.
int bs_gf_tridiag_chain_tc(const void* dw_hi, const void* dw_mid,
                           const void* dw_lo, const void* up_hi,
                           const void* up_mid, const void* up_lo,
                           const void* da, const void* db, void* planes,
                           void* parts, void* state, void* partials,
                           void* counter, void* alphas, void* betas, int nb,
                           int ddp, int dup, int rank, int w_dw, int d_dw,
                           int w_up, int d_up, int kk, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!args_ok(g, kk) || nb <= 0 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const int bn = tile_for(ddp, dup, nb, 3);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const void* dw[3] = {dw_hi, dw_mid, dw_lo};
  const void* up[3] = {up_hi, up_mid, up_lo};
  const ChainArgs a = make_args(dw, up, 3, da, db, planes, parts, state,
                                partials, counter, alphas, kk, g);
  return (int)run_chain<LANCZOS, 3>(bn, a, nb, static_cast<double*>(betas),
                                    0.f, 0.f, kk,
                                    static_cast<cudaStream_t>(stream));
}

// y = H_p u in B4's six-pass form, at tile width bn (32 or 128; 0: the
// launcher's choice for one chain): u in plane 0 of planes [2, ddp, dup]
// and its (hi, mid, lo) in parts [2, 3, ddp, dup][0]; y into plane 1.
int bs_hv_tc(const void* dw_hi, const void* dw_mid, const void* dw_lo,
             const void* up_hi, const void* up_mid, const void* up_lo,
             const void* da, const void* db, void* planes, void* parts,
             int ddp, int dup, int rank, int w_dw, int d_dw, int w_up,
             int d_up, int bn, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!args_ok(g, 1) || (bn != 0 && bn != 32 && bn != 128))
    return (int)cudaErrorInvalidValue;
  if (bn == 0) bn = tile_for(ddp, dup, 1, 3);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const void* dw[3] = {dw_hi, dw_mid, dw_lo};
  const void* up[3] = {up_hi, up_mid, up_lo};
  const ChainArgs a = make_args(dw, up, 3, da, db, planes, parts, nullptr,
                                nullptr, nullptr, nullptr, 1, g);
  const cudaError_t err = launch_step_bn<HV, 3>(
      bn, a, 1, 0, 0.f, 0.f, 0, static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
