// The per-call band-sparse sector matvec for Hopper (sm_90a): the six-pass
// split-bf16 panel product of bs_panel_tc.cuh on the tensor cores.
//
// Replaces the TPU's Pallas kernels of dmft_lanc_ed_tpu/ops/blocksparse.py:
//   B1a  _runs_kernel   -> bs_matvec with the trim runs of the op (the
//                          windows' nonzero 128-tiles), as data
//   B1b  _fused_kernel  -> bs_matvec with one whole-window run per panel
// and of dmft_lanc_ed_tpu/parallel/bs_sharded.py:
//   B5   _local_kernel  -> bs_matvec with a window table: one rank's rows of
//                          B1b on a dw-row-sharded vector (see below)
//
// What it computes, on the RCM-permuted sector vector padded to multiples
// of 128, u[ddp, dup] (f32), and a scale s (f32, a device scalar or a
// value):
//   y = s ((A B) o u + H_dw,p u + u H_up,p)          (f32, [ddp, dup])
//   ss[p] = sum of y^2 over the 128-row panel p      (f32, [ntd])
// ss feeds the fused normalization of a power chain: rsqrt(sum ss) is the
// next step's s, with no host sync.
//
// The product form. The TPU kernels run the three-pass split-bf16 product
// (blocksparse.py _dot3), ~1.2e-6 of max|H u| at the 854k sector; the
// port's B1 has held f32 grade (1e-6 of max|y| against f64) since it was
// first ported. So B1/B5 take B4's six passes over a three-part split with
// each 64-deep stage promoted into an FP32 sum (bs_panel_tc.cuh, P = 3),
// whose error is that of an FP32 FMA product. A call is two launches:
// bs_split3 writes u's (hi, mid, lo) into a scratch buffer (B1 multiplies
// an arbitrary f32 vector: no epilogue has stored its parts, and the TPU
// kernel splits v in its own body), then bs_matvec runs the product and
// the epilogue and finishes ss.
//
// The runs. The TPU kernel B1a unrolled its panels in Python with the runs
// as compile-time constants (one executable per sector). Here the runs are
// a small int32 table per panel, read by every block of that panel as the
// stream of its stages (bs_panel_tc.cuh Runs): one build serves every
// sector, and the whole-window form B1b is the same kernel given one run
// per panel. A stage of zero tiles only adds exact zeros to an FP32 sum,
// so trimmed and whole-window outputs agree bit for bit; pad rows and
// columns of y are exactly 0 because the slabs' pad rows/columns and u's
// pad are exactly 0.
//
// The panel sums without a finish launch: every block writes one f64
// partial of sum y^2 per 64 x 32 sub-tile of its tile, summed in the order
// a 64 x 32 block takes, so the partials do not depend on the tile width;
// the block that draws the last ticket of an atomicAdd counter (left 0 for
// the next call) sums each panel's partials in index order. Reruns are
// bit-identical, there are no float atomics, and no host sync: a call can
// be captured into a CUDA graph.
//
// What bounds it. At the 854k-state (6,6) sector of nbath = 11 (ddp = dup =
// 1024, W_dw = W_up = 640) the six passes over the nonzero window tiles are
// 6 x 1.97 GFLOP of bf16 products: 12 us at the H100's 989 TFLOP/s. u, its
// parts, y (14 MB) and the split slabs (8 MB) stay in the 50 MB L2, so the
// tensor-core operations bound the call; what a block loses is staging
// latency and the per-stage wait of the FP32 promotion. The tile width is
// the launcher's rule of the chains (pick_bn): the narrowest tile whose
// blocks are all resident at once, else 64 x 128 (854k: 64 x 128, 128
// blocks; a B5 shard of 512 x 1024: 64 x 32, 256 blocks at two an SM).
//
// B5, the dw-sharded form. A rank holds the 128-row panels [d ntl, (d+1)
// ntl) of the vector (u_loc, local rows) and, from the halo exchange, u_ext
// = [last d_dw panels of rank d-1 | u_loc | first d_dw panels of rank d+1]
// (zeros past the ends). The split runs over u_ext; the up contraction and
// the diagonal read u_loc's rows (its parts at row 128 d_dw of u_ext's);
// the dw window of local panel i starts at row 128 t[i] of u_ext, a host
// table t[i] = clamp(d ntl + i - d_dw) - (d ntl - d_dw), as the JAX
// package's SMEM input (bs_sharded.py:174-180). Only where the window
// starts differs from B1b: the same tiles are multiplied in the same order,
// an element's sum does not depend on the tile width, and no clamped window
// reaches an edge rank's zero halo, so the ranks' outputs stitched together
// equal B1b's bit for bit, panel sums included. The cross-rank sum of the
// panel sums is a collective outside the kernel.
//
// Every entry point returns cudaGetLastError() of its launch (0 = ok).
#include "bs_panel_tc.cuh"

namespace {

struct MvArgs {
  SplitOp op;                   // the (hi, mid, lo) slabs
  const float *da, *db;         // separable diagonal [rows, rank], [rank, dup]
  const float* u;               // [rows, dup] f32 (B5: u_loc)
  const bf16* u_parts;          // the parts of u's rows (B5: inside w's)
  const bf16* w_parts;          // the parts of the dw windows' rows
  size_t plane;                 // elements between two parts
  const int* t_tab;             // B5: window starts in 128-tiles, else null
  const int *dw_ptr, *dw_tab, *up_ptr, *up_tab;    // the runs
  const float* scale;           // device scalar, or null: scale_value
  float scale_value;
  float* y;                     // [rows, dup]
  double* partials;             // [rows / 64, dup / 32]
  unsigned* counter;            // 0 between launches
  float* ss;                    // [rows / 128]
  Geo g;                        // ddp = rows
};

// one 64 x BN tile of y, its sum-of-squares partials, and the panel sums
// in the last block
template <int BN>
__global__ void __launch_bounds__(PNT, (Ring<BN, 3>::BLOCKS))
mv_tc(const MvArgs a) {
  extern __shared__ uint8_t ring[];
  const Geo& g = a.g;
  const int r0 = blockIdx.y * PM, c0 = blockIdx.x * BN;
  const int i = r0 / 128, j = c0 / 128;
  const int w0 = a.t_tab ? a.t_tab[i] * 128 : dw_window_base(g, i);
  Runs st(a.dw_ptr, a.dw_tab, a.up_ptr, a.up_tab, i, j);
  float acc[BN / 2];
  panel_stream<BN, 3>(acc, ring, a.op, a.u_parts, a.w_parts, a.plane, g, r0,
                      c0, w0, st);

  matvec_epilogue<BN>(acc, a.da, a.db, a.u, a.y,
                      a.scale ? *a.scale : a.scale_value, a.partials,
                      a.counter, a.ss, g, c0);
}

template <int BN>
cudaError_t launch_mv(const MvArgs& a, cudaStream_t s) {
  auto* kern = mv_tc<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<BN, 3>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.g.dup / BN, a.g.ddp / PM);
  kern<<<grid, PNT, Ring<BN, 3>::SMEM_BYTES, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// number of f64 partial sums a call on rows x dup writes (size of
// `partials`): one per 64 x 32 sub-tile
int bs_matvec_nblk(int rows, int dup) { return (rows / PM) * (dup / 32); }

// the output tile's width a call on rows x dup takes on the current device
// (32 or 128; 0 if the device cannot be read)
int bs_matvec_tile(int rows, int dup) {
  const int sms = sm_count();
  return sms > 0 ? pick_bn<3>(rows, dup, 1, sms) : 0;
}

// parts [3, n] bf16 = the (hi, mid, lo) of x [n] f32, n a multiple of 8
int bs_split3(const void* x, void* parts, long n, void* stream) {
  return (int)launch_split<3>(static_cast<const float*>(x),
                              static_cast<bf16*>(parts), n,
                              static_cast<cudaStream_t>(stream));
}

// One matvec over `rows` rows (B1: the whole padded grid, rows = ext = ddp,
// t_tab null; B5: a rank's rows, ext = rows + 2 * 128 d_dw, t_tab [rows /
// 128] int32 window starts in 128-tiles of the halo'd rows, 0 <= 128 t and
// 128 t + w_dw <= ext). dw[3] [rows / 128, 128, w_dw] and up[3] [dup / 128,
// w_up, 128] bf16: the (hi, mid, lo) slabs (B5: the rank's dw slabs); da
// [rows, rank], db [rank, dup] f32; u [rows, dup] f32; parts [3, ext, dup]
// bf16: bs_split3 of the halo'd rows (B1: of u); y [rows, dup] f32; scale
// [1] f32 or null (then scale_value); partials [bs_matvec_nblk(rows, dup)]
// f64 scratch; counter [1] int32, 0 (left 0); ss [rows / 128] f32. Runs:
// dw_ptr [rows / 128 + 1] and up_ptr [dup / 128 + 1] int32 offsets into the
// pair tables dw_tab, up_tab (int32 t0 < t1 pairs, 128-tile units of the
// window, ascending, within [0, w / 128]). bn: the tile width, 32 or 128,
// or 0 for the launcher's choice.
int bs_matvec(const void* dw_hi, const void* dw_mid, const void* dw_lo,
              const void* up_hi, const void* up_mid, const void* up_lo,
              const void* da, const void* db, const void* u,
              const void* parts, const void* t_tab, void* y,
              const void* scale, float scale_value, void* partials,
              void* counter, void* ss, const void* dw_ptr, const void* dw_tab,
              const void* up_ptr, const void* up_tab, int rows, int ext,
              int dup, int rank, int w_dw, int d_dw, int w_up, int d_up,
              int bn, void* stream) {
  const Geo g{rows, dup, rank, w_dw, d_dw, w_up, d_up};
  const int halo = t_tab ? 128 * d_dw : 0;
  if (!(rows > 0 && dup > 0 && rows % 128 == 0 && dup % 128 == 0
        && w_dw > 0 && w_dw % 128 == 0 && w_up > 0 && w_up % 128 == 0
        && w_up <= dup && rank > 0 && rank % 8 == 0
        && ext == rows + 2 * halo && w_dw <= ext
        && (bn == 0 || bn == 32 || bn == 128)))
    return (int)cudaErrorInvalidValue;
  if (bn == 0) bn = bs_matvec_tile(rows, dup);
  if (bn == 0) return (int)cudaErrorInvalidDevice;
  const bf16* w = static_cast<const bf16*>(parts);
  MvArgs a{};
  const void* dws[3] = {dw_hi, dw_mid, dw_lo};
  const void* ups[3] = {up_hi, up_mid, up_lo};
  for (int p = 0; p < 3; ++p) {
    a.op.dw[p] = static_cast<const bf16*>(dws[p]);
    a.op.up[p] = static_cast<const bf16*>(ups[p]);
  }
  a.da = static_cast<const float*>(da);
  a.db = static_cast<const float*>(db);
  a.u = static_cast<const float*>(u);
  a.w_parts = w;
  a.u_parts = w + (size_t)halo * dup;
  a.plane = (size_t)ext * dup;
  a.t_tab = static_cast<const int*>(t_tab);
  a.dw_ptr = static_cast<const int*>(dw_ptr);
  a.dw_tab = static_cast<const int*>(dw_tab);
  a.up_ptr = static_cast<const int*>(up_ptr);
  a.up_tab = static_cast<const int*>(up_tab);
  a.scale = static_cast<const float*>(scale);
  a.scale_value = scale_value;
  a.y = static_cast<float*>(y);
  a.partials = static_cast<double*>(partials);
  a.counter = static_cast<unsigned*>(counter);
  a.ss = static_cast<float*>(ss);
  a.g = g;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bn == 32 ? launch_mv<32>(a, s) : launch_mv<128>(a, s));
}

}  // extern "C"
