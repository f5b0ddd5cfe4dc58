// The zero-tile trim probe's matvec for Hopper (sm_90a): B1's function with
// the three-pass split-bf16 product of bs_panel_tc.cuh (wgmma, pipelined
// through a cp.async ring), the window tiles walked as the probe's forms
// name them.
//
// Replaces the TPU's Pallas kernels of experiments/trim_ab.py:
//   E2a  make_variant.kernel      -> trim_matvec, kind 0: per-panel tile
//                                    LISTS per side (cnt [nt], lst [nt,
//                                    W / 128] int32), walked as the stage
//                                    stream TileList; the probe's four
//                                    modes (untrimmed / dwtrim / uptrim /
//                                    both) list the whole window or the
//                                    nonzero tiles per side
//   E2b  make_static_runs.kernel  -> trim_matvec, kind 1: the op's trim
//                                    RUNS (offsets [nt + 1], (t0, t1)
//                                    pairs), the tables B1a reads, walked
//                                    as the stage stream Runs
//
// What it computes, on the RCM-permuted padded f32 vector u[ddp, dup] and
// a device scalar s:
//   y = s ((A B) o u + H_dw,p u + u H_up,p),  ss[p] = sum over panel p of y^2
// with the hop products x a ~ x_hi a_hi + x_lo a_hi + x_hi a_lo (the TPU
// kernels' three passes, f32 accumulation). A call is two launches: the
// split launch writes u's (hi, lo) into a scratch buffer, then the product
// launch runs the stage stream, the epilogue and the panel sums: one f64
// partial per 64 x 32 sub-tile, the last block by ticket (counter left 0)
// sums each panel's partials in index order (bs_panel_tc.cuh
// matvec_epilogue).
// No finish kernel, no float atomics, no host sync: a call captures into a
// CUDA graph. The tile is B2's rule (pick_bn<2>; 854k: 64 x 64), and y and
// ss are the same bits at every width.
//
// Every form walks its window tiles in ascending order, and a tile a form
// leaves out is all zero: wgmma adds the products of a zero stage to the
// sums as exact zeros, so all five forms give the same bits.
//
// What bounds it. At the 854k-state (6,6) sector of nbath = 11 (1024^2
// padded, W_dw = W_up = 640) the nonzero tiles need 3 x 1.97 GFLOP of bf16
// tensor-core products, 6.0 us at 989 TFLOP/s, against ~20 MB of u, its
// parts, y and the nonzero tiles of the split slabs, which stay in the 50
// MB L2: operations bound it. What a call pays below that is the staging
// latency the ring hides, the L2-to-SM bytes of the staged tiles (fewer in
// the trimmed forms) and the split launch. What each form measures on this
// card: the untrimmed lists walk every window tile; dwtrim, uptrim and both
// skip the zero tiles of a side; the runs skip them from B1a's tables. A
// wave of blocks ends with its slowest, and at 854k the blocks of dw panel
// 2 x up panel 2 walk both windows whole, so the trim saves less than its
// share of tiles.
//
// Every entry point returns cudaGetLastError() of its launches (0 = ok).
#include "bs_panel_tc.cuh"

namespace {

constexpr int LISTS = 0;      // E2a: per-panel tile lists (TileList)
constexpr int RUNS = 1;       // E2b: the trim runs (Runs)

struct TrimArgs {
  SplitOp op;                   // the (hi, lo) slabs
  const float *da, *db;         // separable diagonal [ddp, rank], [rank, dup]
  const float* u;               // [ddp, dup] f32
  const bf16* parts;            // [2, ddp, dup] bf16: u's hi, lo
  const int *dw_a, *dw_b, *up_a, *up_b;   // the tables of the kind
  const float* scale;           // [1] f32
  float* y;                     // [ddp, dup]
  double* partials;             // [ddp / 64, dup / 32]
  unsigned* counter;            // 0 between launches
  float* ss;                    // [ddp / 128]
  Geo g;
};

// one 64 x BN tile of y, its sum-of-squares partials, and the panel sums
// in the last block
template <int BN, int KIND>
__global__ void __launch_bounds__(PNT, (Ring<BN, 2>::BLOCKS))
trim_tc(const TrimArgs a) {
  extern __shared__ uint8_t ring[];
  const Geo& g = a.g;
  const size_t plane = (size_t)g.ddp * g.dup;
  const int r0 = blockIdx.y * PM, c0 = blockIdx.x * BN;
  const int i = r0 / 128, j = c0 / 128;
  const int w0 = dw_window_base(g, i);
  float acc[BN / 2];
  if constexpr (KIND == LISTS) {
    TileList st(a.dw_a, a.dw_b, g.w_dw / 128, a.up_a, a.up_b, g.w_up / 128,
                i, j);
    panel_stream<BN, 2>(acc, ring, a.op, a.parts, a.parts, plane, g, r0, c0,
                        w0, st);
  } else {
    Runs st(a.dw_a, a.dw_b, a.up_a, a.up_b, i, j);
    panel_stream<BN, 2>(acc, ring, a.op, a.parts, a.parts, plane, g, r0, c0,
                        w0, st);
  }

  matvec_epilogue<BN>(acc, a.da, a.db, a.u, a.y, *a.scale, a.partials,
                      a.counter, a.ss, g, c0);
}

template <int BN, int KIND>
cudaError_t launch_trim(const TrimArgs& a, cudaStream_t s) {
  auto* kern = trim_tc<BN, KIND>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<BN, 2>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.g.dup / BN, a.g.ddp / PM);
  kern<<<grid, PNT, Ring<BN, 2>::SMEM_BYTES, s>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(int bn, const TrimArgs& a, cudaStream_t s) {
  if (bn == 32) return launch_trim<32, KIND>(a, s);
  if (bn == 64) return launch_trim<64, KIND>(a, s);
  return launch_trim<128, KIND>(a, s);
}

}  // namespace

extern "C" {

// number of f64 partial sums a call writes (size of `partials`): one per
// 64 x 32 sub-tile
int trim_matvec_nblk(int ddp, int dup) { return (ddp / PM) * (dup / 32); }

// One matvec (E2a: kind 0, E2b: kind 1), two launches, counted in
// *launches. dw_hi/dw_lo [ntd, 128, w_dw] and up_hi/up_lo [ntu, w_up, 128]
// bf16; da [ddp, rank], db [rank, dup] f32; u, y [ddp, dup] f32 (distinct);
// parts [2, ddp, dup] bf16 scratch (u's split); scale [1] f32; partials
// [trim_matvec_nblk] f64 scratch; counter [1] int32, 0 (left 0); ss
// [ddp / 128] f32. Tables, int32, per side: kind 0 cnt [nt] and lst
// [nt, w / 128] (tile indices of the window, ascending); kind 1 offsets
// [nt + 1] and (t0, t1) pairs (the runs, ascending, within [0, w / 128]).
// bn: the tile width, 32, 64 or 128, or 0 for the launcher's choice.
int trim_matvec(const void* dw_hi, const void* dw_lo, const void* up_hi,
                const void* up_lo, const void* da, const void* db,
                const void* u, void* parts, void* y, const void* scale,
                void* partials, void* counter, void* ss, int kind,
                const void* dw_a, const void* dw_b, const void* up_a,
                const void* up_b, int ddp, int dup, int rank, int w_dw,
                int d_dw, int w_up, int d_up, int bn, int* launches,
                void* stream) {
  const Geo g{ddp, dup, rank, w_dw, d_dw, w_up, d_up};
  if (!geo_ok(g) || rank % 8 != 0 || (kind != LISTS && kind != RUNS)
      || (bn != 0 && bn != 32 && bn != 64 && bn != 128)
      || launches == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bn == 0) {
    const int sms = sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    bn = pick_bn<2>(ddp, dup, 1, sms);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split<2>(static_cast<const float*>(u),
                                    static_cast<bf16*>(parts),
                                    (long)ddp * dup, s);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  TrimArgs a{};
  a.op.dw[0] = static_cast<const bf16*>(dw_hi);
  a.op.dw[1] = static_cast<const bf16*>(dw_lo);
  a.op.up[0] = static_cast<const bf16*>(up_hi);
  a.op.up[1] = static_cast<const bf16*>(up_lo);
  a.da = static_cast<const float*>(da);
  a.db = static_cast<const float*>(db);
  a.u = static_cast<const float*>(u);
  a.parts = static_cast<const bf16*>(parts);
  a.dw_a = static_cast<const int*>(dw_a);
  a.dw_b = static_cast<const int*>(dw_b);
  a.up_a = static_cast<const int*>(up_a);
  a.up_b = static_cast<const int*>(up_b);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.partials = static_cast<double*>(partials);
  a.counter = static_cast<unsigned*>(counter);
  a.ss = static_cast<float*>(ss);
  a.g = g;
  err = kind == LISTS ? launch_kind<LISTS>(bn, a, s)
                      : launch_kind<RUNS>(bn, a, s);
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

}  // extern "C"
