// The chain-breakdown probe's Lanczos chain for Hopper (sm_90a): B2's step
// on the split-bf16 panel product of bs_panel_tc.cuh (wgmma, pipelined
// through a cp.async ring), in the product forms the probe times.
//
// Replaces the TPU's Pallas kernel of experiments/chain_breakdown.py:
//   E3  make_variant.kernel  -> bd_chain, mode
//     0 3pass     hi.hi + lo.hi + hi.lo a 16-deep step over the whole
//                 windows (the TPU chain's product; B2's on this card)
//     1 1pass     the same stages, both parts staged, hi.hi alone: 3pass
//                 - 1pass is the tensor cores' share of a B2 step
//     2 bf16pair  the vector planes held only as their bf16 hi/lo parts
//                 (the bytes of f32): the epilogues read hi + lo, every
//                 write splits; what the f32 planes cost B2
//     3 nop1      pass 1's write-back skipped (its dot kept); pass 0 then
//                 writes the parts of plane prv, which the next product
//                 reads
//     4 tileskip  3pass over the runs of the window tiles the probe's
//                 per-tile masks set (ops' tile_masks, host tables): the
//                 zero-tile trim for the chains
//
// One step, on the RCM-permuted padded vector planes (the JAX kernel's
// recurrence: pass 0 takes <u_cur, s_cur H u_cur> before the coupling is
// subtracted, where B2 takes <u_cur, y> after it):
//   pass 0:  y = s_cur H u_cur; partials <u_cur, y>;
//            plane prv = y - coup prv (y at step 0)
//            last block: alpha = s_cur <u_cur, y>, co = alpha s_cur
//   pass 1:  w = prv - co u_cur -> plane prv and its parts (not in nop1);
//            partials |w|^2
//            last block: beta = |w|, coup = beta s_cur, s_cur = 1/beta (0
//            at breakdown, beta <= 1e-30)
// Two launches a step: every block writes its f64 partial and takes a
// ticket from an atomicAdd on an int counter; the block that draws the last
// ticket sums the partials in a fixed order, updates the f64 scalar state
// {s_cur, coup, co} on the card and resets the counter (no finish kernels,
// no float atomics, reruns bit-identical). The JAX kernel carries its state
// in f32 SMEM scalars; the port's plain version carries it in f64, as this
// kernel does.
//
// The planes are B2's: two f32 planes [2, ddp, dup] (none in bf16pair)
// and the two bf16 parts of each, parts [2, 2, ddp, dup]. The product reads
// only the parts; the epilogue that writes a vector's final value writes
// its parts (pass 1, or pass 0 in nop1 and bf16pair). The output tile is
// 64 x 64 at every shape: the tile B2's rule (pick_bn<2>) takes at the
// 854k sector, where the probe measures. One width keeps the file at five
// instantiations, a third of the build of all three widths.
//
// What bounds it. A step is one H u, 3 x 1.97 GFLOP of bf16 tensor-core
// products over the nonzero window tiles at the 854k-state (6,6) sector of
// nbath = 11 (6.0 us at 989 TFLOP/s; 1pass a third), plus a few passes over
// the 4 MB planes, which with the parts and the split slabs stay in the
// 50 MB L2: operations bound it. Below that a step pays the staging latency
// the cp.async ring hides, the L2-to-SM bytes of the staged parts (the same
// in every form but tileskip, which stages the nonzero tiles alone) and two
// launches.
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel_tc.cuh"

namespace {

// the scalar state (double)
constexpr int S_CUR = 0;      // inverse norm of the vector in plane cur
constexpr int COUP = 1;       // coefficient of u_prv in pass 0
constexpr int CO = 2;         // coefficient of u_cur in pass 1
constexpr int P1_NT = 256;    // threads of a pass-1 block (a 64 x 64 tile)

enum Mode { M3PASS = 0, M1PASS = 1, MPAIR = 2, MNOP1 = 3, MSKIP = 4 };

struct BdArgs {
  SplitOp op;                   // the (hi, lo) slabs
  const float *da, *db;         // separable diagonal [ddp, rank], [rank, dup]
  float* planes;                // [2, ddp, dup] f32 (null in bf16pair)
  bf16* parts;                  // [2, 2, ddp, dup] bf16: plane, part
  const int *dw_ptr, *dw_tab, *up_ptr, *up_tab;   // tileskip's runs
  double* state;                // f64: S_CUR, COUP, CO
  double* partials;             // [bd_chain_nblk] f64
  unsigned* counter;            // 0 between launches
  double *alphas, *betas;       // [kk] f64
  Geo g;
};

__device__ __forceinline__ float2 pair_value(const bf16* hi, size_t plane) {
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi));
  const float2 l = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(hi + plane));
  return make_float2(h.x + l.x, h.y + l.y);
}

// the values of plane pl at off, off + 1: the f32 plane, or (bf16pair) the
// sum hi + lo of its parts
template <bool PAIR>
__device__ __forceinline__ float2 read2(const BdArgs& a, int pl, size_t off) {
  const size_t plane = (size_t)a.g.ddp * a.g.dup;
  if constexpr (PAIR)
    return pair_value(a.parts + 2 * pl * plane + off, plane);
  else
    return *reinterpret_cast<const float2*>(a.planes + pl * plane + off);
}

// pass 0 on the 64 x BN tile (blockIdx.x, blockIdx.y)
template <int BN, int MODE>
__global__ void __launch_bounds__(PNT, (Ring<BN, 2>::BLOCKS))
bd_pass0(const BdArgs a, int cur, int k) {
  extern __shared__ uint8_t ring[];
  constexpr bool PAIR = MODE == MPAIR;
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  const int r0 = blockIdx.y * PM, c0 = blockIdx.x * BN;
  const bf16* u_parts = a.parts + (size_t)(2 * cur) * plane;
  bf16* p_parts = a.parts + (size_t)(2 * (1 - cur)) * plane;
  float acc[BN / 2];
  if constexpr (MODE == MSKIP) {
    const int i = r0 / 128;
    Runs st(a.dw_ptr, a.dw_tab, a.up_ptr, a.up_tab, i, c0 / 128);
    panel_stream<BN, 2>(acc, ring, a.op, u_parts, u_parts, plane, g, r0, c0,
                        dw_window_base(g, i), st);
  } else {
    panel_product<BN, 2, MODE == M1PASS ? 1 : 3>(acc, ring, a.op, u_parts,
                                                 plane, g, r0, c0);
  }

  const float s_cur = (float)a.state[S_CUR];
  const float coup = (float)a.state[COUP];
  // this thread's elements: rows ra and ra + 8, column pairs cb + 8 j
  const int t = threadIdx.x;
  const int ra = r0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int cb = c0 + 2 * (t & 3);
  float d[BN / 2];
  tile_diag<BN>(d, a.da, a.db, g, ra, cb);
  double part[1] = {0.0};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      const size_t off = (size_t)(ra + 8 * h) * g.dup + cb + 8 * j;
      const float2 uc = read2<PAIR>(a, cur, off);
      float2 y;
      y.x = s_cur * fmaf(d[e], uc.x, acc[e]);
      y.y = s_cur * fmaf(d[e + 1], uc.y, acc[e + 1]);
      part[0] += (double)uc.x * (double)y.x + (double)uc.y * (double)y.y;
      if (k > 0) {
        const float2 q = read2<PAIR>(a, 1 - cur, off);
        y.x = y.x - coup * q.x;
        y.y = y.y - coup * q.y;
      }
      if constexpr (!PAIR)
        *reinterpret_cast<float2*>(a.planes + (1 - cur) * plane + off) = y;
      if constexpr (PAIR || MODE == MNOP1)
        store_parts<2>(y.x, y.y, p_parts, plane, off);
    }
  }
  double tot;
  const int nblk = gridDim.x * gridDim.y;
  if (last_block_sum<PNT, 1>(part, a.partials, a.counter,
                             blockIdx.y * gridDim.x + blockIdx.x, nblk, nblk,
                             &tot)
      && t == 0) {
    const double alpha = a.state[S_CUR] * tot;
    a.alphas[k] = alpha;
    a.state[CO] = alpha * a.state[S_CUR];
  }
}

// the values of plane pl at off .. off + 3 (as read2)
template <bool PAIR>
__device__ __forceinline__ float4 read4(const BdArgs& a, int pl, size_t off) {
  const size_t plane = (size_t)a.g.ddp * a.g.dup;
  if constexpr (PAIR) {
    const bf16* p = a.parts + 2 * pl * plane + off;
    const float2 v0 = pair_value(p, plane), v1 = pair_value(p + 2, plane);
    return make_float4(v0.x, v0.y, v1.x, v1.y);
  } else {
    return *reinterpret_cast<const float4*>(a.planes + pl * plane + off);
  }
}

// pass 1 on the 64 x 64 tile (blockIdx.x, blockIdx.y): w = prv - co u_cur
template <int MODE>
__global__ void __launch_bounds__(P1_NT)
bd_pass1(const BdArgs a, int cur, int k) {
  constexpr bool PAIR = MODE == MPAIR;
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  bf16* p_parts = a.parts + (size_t)(2 * (1 - cur)) * plane;
  const float co = (float)a.state[CO];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 64;
  const int t = threadIdx.x;
  double part[1] = {0.0};
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * P1_NT + t;
    const size_t off = (size_t)(r0 + idx / 16) * g.dup + c0 + (idx % 16) * 4;
    const float4 uc = read4<PAIR>(a, cur, off);
    float4 w = read4<PAIR>(a, 1 - cur, off);
    w.x -= co * uc.x;
    w.y -= co * uc.y;
    w.z -= co * uc.z;
    w.w -= co * uc.w;
    part[0] += (double)w.x * w.x + (double)w.y * w.y + (double)w.z * w.z
               + (double)w.w * w.w;
    if constexpr (MODE != MNOP1) {
      if constexpr (!PAIR)
        *reinterpret_cast<float4*>(a.planes + (1 - cur) * plane + off) = w;
      store_parts<2>(w.x, w.y, p_parts, plane, off);
      store_parts<2>(w.z, w.w, p_parts, plane, off + 2);
    }
  }
  double tot;
  const int nblk = gridDim.x * gridDim.y;
  if (last_block_sum<P1_NT, 1>(part, a.partials, a.counter,
                               blockIdx.y * gridDim.x + blockIdx.x, nblk,
                               nblk, &tot)
      && t == 0) {
    const double beta = sqrt(tot);
    a.betas[k] = beta;
    a.state[COUP] = beta * a.state[S_CUR];
    a.state[S_CUR] = beta > 1e-30 ? 1.0 / beta : 0.0;
  }
}

// kk steps at tile width BN, two launches each, counted in *launches
template <int BN, int MODE>
cudaError_t run_chain(const BdArgs& a, int kk, int* launches,
                      cudaStream_t s) {
  auto* pass0 = bd_pass0<BN, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      pass0, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<BN, 2>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid0(a.g.dup / BN, a.g.ddp / PM), grid1(a.g.dup / 64,
                                                      a.g.ddp / 64);
  for (int k = 0; k < kk; ++k) {
    const int cur = k % 2;
    pass0<<<grid0, PNT, Ring<BN, 2>::SMEM_BYTES, s>>>(a, cur, k);
    bd_pass1<MODE><<<grid1, P1_NT, 0, s>>>(a, cur, k);
    *launches += 2;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int MODE>
cudaError_t run_mode(const BdArgs& a, int kk, int* launches,
                     cudaStream_t s) {
  return run_chain<64, MODE>(a, kk, launches, s);
}

}  // namespace

extern "C" {

// kk Lanczos steps of one chain in product form `mode` (see the top).
// dw_hi/dw_lo [ntd, 128, w_dw] and up_hi/up_lo [ntu, w_up, 128] bf16: the
// split slabs; da [ddp, rank], db [rank, dup] f32; planes [2, ddp, dup]
// f32, plane 0 the normalized start, plane 1 zeros (null in bf16pair);
// parts [2, 2, ddp, dup] bf16: parts[0] the split of the start, parts[1]
// zeros; tileskip: the runs dw_ptr [ntd + 1], dw_tab, up_ptr [ntu + 1],
// up_tab int32 (the (offsets, pairs) tables of bs_matvec; null in the
// other forms); state [4] f64 = {1, 0, 0, 0}; partials [(ddp / 64) (dup /
// 32)] f64 (B2's: the most a step writes);
// counter [1] int32, 0 (left 0); alphas, betas [kk] f64; *launches grows
// by the kernels launched (two a step).
int bd_chain(const void* dw_hi, const void* dw_lo, const void* up_hi,
             const void* up_lo, const void* da, const void* db, void* planes,
             void* parts, const void* dw_ptr, const void* dw_tab,
             const void* up_ptr, const void* up_tab, void* state,
             void* partials, void* counter, void* alphas, void* betas,
             int mode, int ddp, int dup, int rank, int w_dw, int d_dw,
             int w_up, int d_up, int kk, int* launches, void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  const bool skip = mode == MSKIP;
  if (!geo_ok(g) || rank % 8 != 0 || kk <= 0 || mode < M3PASS
      || mode > MSKIP || parts == nullptr || launches == nullptr
      || (mode != MPAIR && planes == nullptr)
      || (skip && (dw_ptr == nullptr || dw_tab == nullptr
                   || up_ptr == nullptr || up_tab == nullptr)))
    return (int)cudaErrorInvalidValue;
  BdArgs a{};
  a.op.dw[0] = static_cast<const bf16*>(dw_hi);
  a.op.dw[1] = static_cast<const bf16*>(dw_lo);
  a.op.up[0] = static_cast<const bf16*>(up_hi);
  a.op.up[1] = static_cast<const bf16*>(up_lo);
  a.da = static_cast<const float*>(da);
  a.db = static_cast<const float*>(db);
  a.planes = mode == MPAIR ? nullptr : static_cast<float*>(planes);
  a.parts = static_cast<bf16*>(parts);
  a.dw_ptr = static_cast<const int*>(dw_ptr);
  a.dw_tab = static_cast<const int*>(dw_tab);
  a.up_ptr = static_cast<const int*>(up_ptr);
  a.up_tab = static_cast<const int*>(up_tab);
  a.state = static_cast<double*>(state);
  a.partials = static_cast<double*>(partials);
  a.counter = static_cast<unsigned*>(counter);
  a.alphas = static_cast<double*>(alphas);
  a.betas = static_cast<double*>(betas);
  a.g = g;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case M1PASS: return (int)run_mode<M1PASS>(a, kk, launches, s);
    case MPAIR: return (int)run_mode<MPAIR>(a, kk, launches, s);
    case MNOP1: return (int)run_mode<MNOP1>(a, kk, launches, s);
    case MSKIP: return (int)run_mode<MSKIP>(a, kk, launches, s);
    default: return (int)run_mode<M3PASS>(a, kk, launches, s);
  }
}

}  // extern "C"
