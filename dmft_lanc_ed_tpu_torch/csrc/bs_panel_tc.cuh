// The split-bf16 band-sparse panel product of the chain kernels B2, B3 and
// B4 (bs_chain_tc.cu), of the per-call matvec kernels B1 and B5
// (bs_matvec.cu) and of the probes E2 (trim_ab.cu) and E3
// (chain_breakdown.cu) on Hopper's warpgroup tensor cores (wgmma, sm_90a).
//
// The probe E1 (chain_probe.cu) runs the six-pass product on A resident in
// shared memory (mma_stage_ab), with no ring.
//
// Replaces the panel applies of the TPU's Pallas chain kernels
// (dmft_lanc_ed_tpu/ops/bs_chain.py), in the product form each has, and
// carries B1/B5 at FP32 grade in B4's form. With
// P = 2 bf16 parts a side (B2 and B3: `_hv_panel`, walked by _tridiag_kernel
// and _cheb_kernel), the three-pass product of blocksparse.py _dot3,
//   x a ~ x_hi a_hi + x_lo a_hi + x_hi a_lo      (f32 accumulation),
// x_hi = bf16(x), x_lo = bf16(x - x_hi): the split's ~1.5e-5 relative per
// product, the TPU's B2/B3 contract and the E2/E3 probes' (E3's "1pass"
// form issues hi.hi alone over the same stages). With P = 3 (B4:
// `_hv_panel_f32` of _gf_tridiag_kernel, whose dots run at precision
// HIGHEST, Mosaic's six bf16 passes over a three-part split), the six-pass
// product
//   x a ~ hi.hi + hi.mid + mid.hi + hi.lo + lo.hi + mid.mid,
// mid = bf16(x - hi), lo = bf16(x - hi - mid): 24 significant bits a side,
// f32's own, for the GF chains' ~1e-7 per-matvec contract and B1/B5's f32
// products. Every split is
// round to nearest even, in f32 arithmetic, per 128-tile of the dw and up
// windows with the JAX package's window clamps (Geo below).
//
// What bounds the product on this card and what the design does about it.
// At the 854k-state (6,6) sector of nbath = 11 one H u is P(P+1)/2 x 2.0
// GFLOP of bf16 products over the nonzero window tiles (6 us three-pass, 12
// us six-pass at the H100's 989 TFLOP/s dense bf16 peak) over operands that
// all stay in the 50 MB L2: operations bound it, and what a simple kernel
// loses is the latency of staging, not bandwidth. So:
// - Both operands of every stage are plain bf16 tiles in global memory. The
//   slabs are split once per op, and every vector plane is stored as f32
//   plus its P bf16 parts, written once by the epilogue that produces the
//   vector (B1/B5: by a split launch before the product; nothing is split
//   while it is staged).
// - A block is one warpgroup (128 threads) and owns a 64 x BN output tile,
//   BN = 128, 64 or 32 chosen by the launcher from the grid (bs_chain_tc.cu,
//   bs_matvec.cu).
//   Its contraction is one continuous stream of 64-deep stages, the dw
//   window's first and then the up window's (the chains: the whole windows;
//   B1/B5: the runs of 128-tiles their tables list, the zero tiles of the
//   windows skipped; E2/E3: the tiles their forms list), through a ring of
//   3-4 stages in
//   dynamic shared memory filled by cp.async (16 B a thread). While the
//   tensor cores run stage s, the copies of stages s+1 .. s+STAGES-2 are in
//   flight and the wgmma group of stage s-1 retires; one __syncthreads a
//   stage.
// - A stage holds the P parts of A [64 rows x 64 deep] (K-major: the dw slab
//   rows, or u's rows over the lane window) and of B [64 deep x BN columns]
//   (MN-major: u's window rows, or the up slab), each as rows of 128 bytes
//   in the 128-byte swizzle wgmma's descriptors name (16-byte chunk c of
//   row r sits at chunk c ^ (r % 8); BN = 128 is two 64-column halves, BN =
//   32 rows of 64 bytes in the 64-byte swizzle). Per 16-deep step the
//   warpgroup starts the passes as m64nBNk16 wgmma with both operands from
//   shared memory and the f32 sums in registers. At six passes the tensor
//   cores' f32 accumulation over the interleaved passes strays from an FMA
//   chain's: summed that way, B4's product missed chip_smoke.py's gate of
//   twice the FP32 FMA product's error against f64. So each stage's
//   products go to a zeroed register tile that FP32 adds then fold into the
//   sum, and the stage's wgmma group is waited for before the add.
// - Every output element's products are summed in ascending window order
//   whatever BN is, by one block, so reruns are bit-identical and an
//   element's sum does not depend on the tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// The sector geometry. On the RCM-permuted sector vector padded to
// multiples of 128, u[ddp, dup] (f32), the panel apply is
//   H u = (A B) o u + H_dw,p u + u H_up,p
// with the dw hops as banded row slabs dw[ntd, 128, W_dw] (panel i of rows
// times a window of W_dw rows of u starting at tile clamp(i - d_dw, 0,
// (ddp - W_dw)/128)) and the up hops as banded column slabs up[ntu, W_up,
// 128] (a lane window of u starting at clamp((j - d_up) * 128, 0,
// dup - W_up) times column panel j's slab). The window clamps are those of
// the JAX package's blocksparse.py:579 and :597.
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

constexpr int PM = 64;        // output rows per block (wgmma's m64)
constexpr int PK = 64;        // contraction depth per stage
constexpr int PNT = 128;      // threads per block: one warpgroup
constexpr int A_BYTES = PM * PK * 2;          // one part of the A tile
constexpr int SM_SMEM = 233472;               // shared memory of an SM

// ring geometry of the 64 x BN tile with P parts a side: 3-4 stages at
// three passes (two blocks an SM below BN = 128), 3 at six (a stage of
// BN = 128 is 72 KB); BLOCKS: the blocks an SM holds at once
template <int BN, int P>
struct Ring {
  static constexpr int STAGES = P == 3 || BN == 64 ? 3 : 4;
  static constexpr int B_BYTES = PK * BN * 2;         // one part of B
  static constexpr int STAGE_BYTES = P * (A_BYTES + B_BYTES);
  // + 1024: the ring starts on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
  // + 3 KB a block: its static shared memory and the SM's reserve
  static constexpr int BLOCKS = 2 * (SMEM_BYTES + 3072) <= SM_SMEM ? 2 : 1;
};

// x -> (bf16(x), bf16(x - bf16(x))), round to nearest even: the JAX
// package's split (blocksparse.py:130) and torch's .to(torch.bfloat16)
__device__ __forceinline__ void split2(float x, float y, __nv_bfloat162& hi,
                                       __nv_bfloat162& lo) {
  const bf16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = __halves2bfloat162(hx, hy);
  lo = __halves2bfloat162(__float2bfloat16_rn(x - __bfloat162float(hx)),
                          __float2bfloat16_rn(y - __bfloat162float(hy)));
}

// x -> (hi, mid, lo): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), round to nearest even; both differences are exact in f32
// (ops/bf16x3.py split3_bf16)
__device__ __forceinline__ void split3(float x, float y, __nv_bfloat162& hi,
                                       __nv_bfloat162& mid,
                                       __nv_bfloat162& lo) {
  const bf16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  const float rx = x - __bfloat162float(hx), ry = y - __bfloat162float(hy);
  const bf16 mx = __float2bfloat16_rn(rx), my = __float2bfloat16_rn(ry);
  hi = __halves2bfloat162(hx, hy);
  mid = __halves2bfloat162(mx, my);
  lo = __halves2bfloat162(__float2bfloat16_rn(rx - __bfloat162float(mx)),
                          __float2bfloat16_rn(ry - __bfloat162float(my)));
}

// the P parts of the pair of f32 values (x, y) into parts[p][off] (p < P)
template <int P>
__device__ __forceinline__ void store_parts(float x, float y, bf16* parts,
                                            size_t plane, size_t off) {
  __nv_bfloat162 v[3];
  if constexpr (P == 2)
    split2(x, y, v[0], v[1]);
  else
    split3(x, y, v[0], v[1], v[2]);
#pragma unroll
  for (int p = 0; p < P; ++p)
    *reinterpret_cast<__nv_bfloat162*>(parts + p * plane + off) = v[p];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes (cp.async) -> visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma's 64-bit shared-memory matrix descriptor: start address, leading
// and stride byte offsets (all in 16-byte units) and the swizzle (1: 128
// bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (swz << 62);
}

// d += A[64 x 16] B[16 x N]: A K-major, B MN-major (transposed), both from
// shared memory, bf16 in, f32 out
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Start the cp.async copies of one stage into the ring slot at `slot`
// (shared address): a[p] points at part p of the A tile's first element (64
// rows of pitch lda, 64 deep), b[p] at the B tile's (64 deep, pitch ldb,
// BN columns).
template <int BN, int P>
__device__ __forceinline__ void load_stage(uint32_t slot,
                                           const bf16* const (&a)[P], int lda,
                                           const bf16* const (&b)[P],
                                           int ldb) {
  const int t = threadIdx.x;
#pragma unroll
  for (int it = 0; it < 4; ++it) {            // A: 64 rows x 8 chunks
    const int q = it * PNT + t;
    const int r = q >> 3, c = q & 7;
    const uint32_t dst = slot + r * 128 + ((c ^ (r & 7)) << 4);
    const size_t src = (size_t)r * lda + c * 8;
#pragma unroll
    for (int p = 0; p < P; ++p) cp_async16(dst + p * A_BYTES, a[p] + src);
  }
  constexpr int CPR = BN / 8;                 // 16-byte chunks per B row
  const uint32_t bslot = slot + P * A_BYTES;
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {      // B: 64 rows x CPR chunks
    const int q = it * PNT + t;
    const int k = q / CPR, c = q % CPR;
    uint32_t off;
    if (BN == 128)
      off = (c >> 3) * (PK * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4);
    else if (BN == 64)
      off = k * 128 + ((c ^ (k & 7)) << 4);
    else
      off = k * 64 + ((c ^ ((k >> 1) & 3)) << 4);
    const size_t src = (size_t)k * ldb + c * 8;
#pragma unroll
    for (int p = 0; p < P; ++p)
      cp_async16(bslot + off + p * Ring<BN, P>::B_BYTES, b[p] + src);
  }
}

// the passes of one 64-deep step: NP = 3 at P = 2 (hi.hi, lo.hi, hi.lo),
// NP = 6 at P = 3 (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid); NP = 1 at
// P = 2 is hi.hi alone over the same staged parts (the probe E3's "1pass"
// form: the staging of the three-pass product without two of its
// tensor-core passes). The P parts of A start at aslot, A_BYTES apart, the
// P parts of B at bslot, Ring<BN, P>::B_BYTES apart.
template <int BN, int P, int NP = P * (P + 1) / 2>
__device__ __forceinline__ void mma_stage_ab(float (&acc)[BN / 2],
                                             uint32_t aslot,
                                             uint32_t bslot) {
  static_assert(NP == P * (P + 1) / 2 || (P == 2 && NP == 1),
                "the passes of a P-part product");
  // B: 8 rows of depth are one swizzle atom (1024 bytes, or 512 at BN = 32)
  constexpr uint32_t B_SBO = BN == 32 ? 512 : 1024;
  constexpr uint32_t B_LBO = PK * 128;        // BN = 128: the next 64 columns
  constexpr uint64_t B_SWZ = BN == 32 ? 2 : 1;
#pragma unroll
  for (int ks = 0; ks < PK / 16; ++ks) {
    uint64_t da[P], db[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      da[p] = smem_desc(aslot + p * A_BYTES + ks * 32, 16, 1024, 1);
      db[p] = smem_desc(bslot + p * Ring<BN, P>::B_BYTES + ks * 2 * B_SBO,
                        B_LBO, B_SBO, B_SWZ);
    }
    if constexpr (NP == 1) {
      wgmma_bf16<BN>(acc, da[0], db[0]);
    } else if constexpr (P == 2) {
      wgmma_bf16<BN>(acc, da[0], db[0]);
      wgmma_bf16<BN>(acc, da[1], db[0]);
      wgmma_bf16<BN>(acc, da[0], db[1]);
    } else {
      wgmma_bf16<BN>(acc, da[0], db[0]);
      wgmma_bf16<BN>(acc, da[0], db[1]);
      wgmma_bf16<BN>(acc, da[1], db[0]);
      wgmma_bf16<BN>(acc, da[0], db[P - 1]);
      wgmma_bf16<BN>(acc, da[P - 1], db[0]);
      wgmma_bf16<BN>(acc, da[1], db[1]);
    }
  }
}

// mma_stage_ab on a ring slot: the stage's A parts, then its B parts
template <int BN, int P, int NP = P * (P + 1) / 2>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2],
                                          uint32_t slot) {
  mma_stage_ab<BN, P, NP>(acc, slot, slot + P * A_BYTES);
}

// The split slabs the product reads: part p of the dw slabs [ntd, 128,
// W_dw] and of the up slabs [ntu, W_up, 128] (p < P).
struct SplitOp {
  const bf16* dw[3];
  const bf16* up[3];
};

// The stages of a block's contraction, in order: the dw window's 64-deep
// slices, then the up window's. stage(s, k0) is called for s = 0, 1, 2, ...
// in turn; it returns 0 past the last stage, else DW_STAGE or UP_STAGE with
// k0 the stage's first element in its window. count() bounds the stages
// walked: with the stages asked for so far, it covers every stage the main
// loop reaches (the loop asks STAGES - 1 ahead).
constexpr int DW_STAGE = 1;
constexpr int UP_STAGE = 2;

// the whole windows (B2, B3, B4, E3): W_dw / 64 + W_up / 64 >= 4 stages
struct WholeWindows {
  int n_dw, n;
  __device__ __forceinline__ WholeWindows(const Geo& g)
      : n_dw(g.w_dw / PK), n(g.w_dw / PK + g.w_up / PK) {}
  __device__ __forceinline__ int stage(int s, int& k0) const {
    if (s >= n) return 0;
    if (s < n_dw) {
      k0 = s * PK;
      return DW_STAGE;
    }
    k0 = (s - n_dw) * PK;
    return UP_STAGE;
  }
  __device__ __forceinline__ int count() const { return n; }
};

// the one run of the first 128-tile of a window
__device__ const int kFirstTile[2] = {0, 1};

// Runs of 128-tiles (B1, B5, E2b, E3's tileskip): the (t0, t1) pairs of dw
// panel i's runs in the table (dw_ptr, dw_tab), then up panel j's in
// (up_ptr, up_tab), each run two stages a tile, ascending
// (ops/blocksparse.py _runs_table). A block with no run at all walks the
// first tile of its dw window: all its tiles are zero, so its two stages
// add exact zeros and the loop runs at least once. The cursor steps
// through the table as the stages are asked for; a run's pair is read
// when the cursor reaches it.
struct Runs {
  const int* dw;                // dw panel i's pairs
  const int* up;                // up panel j's pairs
  int n_dw, n;                  // dw runs; dw and up runs
  int q;                        // the cursor's run: dw runs, then up runs
  int k, k_end;                 // its next stage's first element, its end
  int asked;                    // stages handed out so far

  __device__ __forceinline__ Runs(const int* __restrict__ dw_ptr,
                                  const int* __restrict__ dw_tab,
                                  const int* __restrict__ up_ptr,
                                  const int* __restrict__ up_tab, int i,
                                  int j)
      : q(0), asked(0) {
    const int d0 = __ldg(dw_ptr + i), u0 = __ldg(up_ptr + j);
    dw = dw_tab + 2 * d0;
    up = up_tab + 2 * u0;
    n_dw = __ldg(dw_ptr + i + 1) - d0;
    n = n_dw + __ldg(up_ptr + j + 1) - u0;
    if (n == 0) {
      dw = kFirstTile;
      n_dw = n = 1;
    }
    load();
  }
  __device__ __forceinline__ void load() {
    const int* r = q < n_dw ? dw + 2 * q : up + 2 * (q - n_dw);
    k = __ldg(r) * 128;
    k_end = __ldg(r + 1) * 128;
  }
  __device__ __forceinline__ int stage(int, int& k0) {
    if (q >= n) return 0;
    const int kind = q < n_dw ? DW_STAGE : UP_STAGE;
    k0 = k;
    k += PK;
    ++asked;
    if (k == k_end && ++q < n) load();
    return kind;
  }
  __device__ __forceinline__ int count() const { return asked; }
};

// Lists of 128-tiles (E2a): dw panel i's tiles lst_dw[i, :cnt_dw[i]], then
// up panel j's lst_up[j, :cnt_up[j]] (window tiles, ascending; a list's row
// holds ntw entries, a count above ntw reads ntw), two stages a tile, from
// a cursor as Runs walks its runs; a block with no listed tile walks the
// first tile of its dw window, as Runs does.
struct TileList {
  const int* dw;                // dw panel i's tiles
  const int* up;                // up panel j's tiles
  int n_dw, n;                  // dw tiles; dw and up tiles
  int q;                        // the cursor's tile: dw tiles, then up tiles
  int k, k_end;                 // its next stage's first element, its end
  int asked;                    // stages handed out so far

  __device__ __forceinline__ TileList(const int* __restrict__ cnt_dw,
                                      const int* __restrict__ lst_dw,
                                      int ntw_dw,
                                      const int* __restrict__ cnt_up,
                                      const int* __restrict__ lst_up,
                                      int ntw_up, int i, int j)
      : q(0), asked(0) {
    dw = lst_dw + (size_t)i * ntw_dw;
    up = lst_up + (size_t)j * ntw_up;
    n_dw = min(__ldg(cnt_dw + i), ntw_dw);
    n = n_dw + min(__ldg(cnt_up + j), ntw_up);
    if (n == 0) {
      dw = kFirstTile;
      n_dw = n = 1;
    }
    load();
  }
  __device__ __forceinline__ void load() {
    k = __ldg(q < n_dw ? dw + q : up + (q - n_dw)) * 128;
    k_end = k + 128;
  }
  __device__ __forceinline__ int stage(int, int& k0) {
    if (q >= n) return 0;
    const int kind = q < n_dw ? DW_STAGE : UP_STAGE;
    k0 = k;
    k += PK;
    ++asked;
    if (k == k_end && ++q < n) load();
    return kind;
  }
  __device__ __forceinline__ int count() const { return asked; }
};

// acc = the hop products of the 64 x BN output tile (r0, c0) of H_p u,
// without the diagonal, over the stages of `st`: the dw slab rows r0.. of
// panel r0/128 times the rows of w from row w0 on (the dw window), then
// u's rows r0.. over the lane window times the columns c0.. of up slab
// c0/128. u_parts and w_parts: the P bf16 parts of u (the tile's own rows,
// [ddp, dup]) and of w (the dw window's source), `plane` elements apart;
// the single-vector kernels pass w = u. `ring`: the block's dynamic shared
// memory. The accumulator is wgmma's: thread t holds, for j < BN/8 and
// h < 2, acc[4j + 2h + {0,1}] = element (16 (t/32) + (t%32)/4 + 8h, 8j +
// 2 (t%4) + {0,1}) of the tile. At P = 3 each stage's products are summed
// by wgmma into a zeroed register tile, then added to acc with FP32 adds:
// the tensor cores' accumulation spans one 64-deep stage, so a stage of
// zero tiles leaves acc as it was, and every element's sum is the same
// whatever BN is and whichever zero stages a stream skips. At P = 2 wgmma
// accumulates into acc across the stages; a stage of zero tiles adds exact
// zeros to it (the E2 and E3 probes' forms hold that to the bit). NP: the
// passes a stage (mma_stage).
template <int BN, int P, int NP = P * (P + 1) / 2, class Stream>
__device__ __forceinline__ void panel_stream(float (&acc)[BN / 2],
                                             uint8_t* ring, const SplitOp& op,
                                             const bf16* __restrict__ u_parts,
                                             const bf16* __restrict__ w_parts,
                                             size_t plane, const Geo& g,
                                             int r0, int c0, int w0,
                                             Stream& st) {
  constexpr int S = Ring<BN, P>::STAGES;
  const uint32_t base = (smem_u32(ring) + 1023u) & ~1023u;
  const int i = r0 / 128, j = c0 / 128;
  const int s_up = min(max((j - g.d_up) * 128, 0), g.dup - g.w_up);
  const size_t dw_row = ((size_t)i * 128 + (r0 % 128)) * g.w_dw;
  const size_t up_col = (size_t)j * g.w_up * 128 + (c0 % 128);

  auto fetch = [&](int s) {
    int k0;
    const int kind = st.stage(s, k0);
    if (kind) {
      const uint32_t slot = base + (s % S) * Ring<BN, P>::STAGE_BYTES;
      const bf16* a[P];
      const bf16* b[P];
      if (kind == DW_STAGE) {
        const size_t ao = dw_row + (size_t)k0;
        const size_t bo = (size_t)(w0 + k0) * g.dup + c0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          a[p] = op.dw[p] + ao;
          b[p] = w_parts + p * plane + bo;
        }
        load_stage<BN, P>(slot, a, g.w_dw, b, g.dup);
      } else {
        const size_t ao = (size_t)r0 * g.dup + s_up + k0;
        const size_t bo = up_col + (size_t)k0 * 128;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          a[p] = u_parts + p * plane + ao;
          b[p] = op.up[p] + bo;
        }
        load_stage<BN, P>(slot, a, g.dup, b, 128);
      }
    }
    cp_async_commit();          // always: the group count stays uniform
  };

#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fetch(s);
  cp_async_wait<S - 2>();       // stage 0 has landed
  fence_async_smem();
  __syncthreads();
  // every stream has a stage 0, so the loop takes no guard: a guarded loop
  // let nvcc place the skip path's zeroed sums after the loop, inside the
  // wgmma pipeline, and ptxas then serialized it (warning C7515)
  int s = 0;
#pragma unroll 1
  do {
    const uint32_t slot = base + (s % S) * Ring<BN, P>::STAGE_BYTES;
    if constexpr (P == 3) {
      float part[BN / 2];
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) part[q] = 0.f;
      wgmma_fence();
      mma_stage<BN, P>(part, slot);
      wgmma_commit();
      wgmma_wait<0>();          // this stage's products are done
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) {
        asm volatile("" : "+f"(part[q])::"memory");   // read after the wait
        acc[q] += part[q];
      }
    } else {
      wgmma_fence();
      mma_stage<BN, P, NP>(acc, slot);
      wgmma_commit();
      wgmma_wait<1>();          // stage s-1's products are done (this warp)
    }
    cp_async_wait<S - 3>();     // stage s+1 has landed (this thread's part)
    fence_async_smem();
    __syncthreads();            // ... for every warp: slot (s-1) % S is free
    fetch(s + S - 1);
  } while (++s < st.count());
  wgmma_wait<0>();
  // the sums are read from here on: no use of them may move above the wait
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) asm volatile("" : "+f"(acc[q])::"memory");
}

// the chains' product: panel_stream over the whole windows of u, the dw
// window at the op's clamp
template <int BN, int P, int NP = P * (P + 1) / 2>
__device__ __forceinline__ void panel_product(float (&acc)[BN / 2],
                                              uint8_t* ring, const SplitOp& op,
                                              const bf16* __restrict__ u_parts,
                                              size_t plane, const Geo& g,
                                              int r0, int c0) {
  WholeWindows st(g);
  panel_stream<BN, P, NP>(acc, ring, op, u_parts, u_parts, plane, g, r0, c0,
                          dw_window_base(g, r0 / 128), st);
}

// The separable diagonal (A B)[r, c] of a thread's elements of a 64 x BN
// tile in acc's layout: rows ra and ra + 8, column pairs cb + 8 j.
template <int BN>
__device__ __forceinline__ void tile_diag(float (&d)[BN / 2], const float* da,
                                          const float* db, const Geo& g,
                                          int ra, int cb) {
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) d[q] = 0.f;
#pragma unroll 8                // rank is a multiple of 8: loads in batches
  for (int q = 0; q < g.rank; ++q) {
    const float a0 = da[(size_t)ra * g.rank + q];
    const float a1 = da[(size_t)(ra + 8) * g.rank + q];
    const float* brow = db + (size_t)q * g.dup + cb;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(brow + 8 * j);
      d[4 * j + 0] = fmaf(a0, bv.x, d[4 * j + 0]);
      d[4 * j + 1] = fmaf(a0, bv.y, d[4 * j + 1]);
      d[4 * j + 2] = fmaf(a1, bv.x, d[4 * j + 2]);
      d[4 * j + 3] = fmaf(a1, bv.y, d[4 * j + 3]);
    }
  }
}

// Sum of Q doubles per thread over the NTHR threads of the block, each
// written to partials[blk * Q + q], then the cross-block sum of all npart
// partials by the last block to arrive of nblk (an atomicAdd ticket on
// *counter, reset to 0 by that block): returns true in every thread of
// that block, with the fixed-order total in *total.
template <int NTHR, int Q>
__device__ __forceinline__ bool last_block_sum(const double (&v)[Q],
                                               double* partials,
                                               unsigned* counter, int blk,
                                               int nblk, int npart,
                                               double* total) {
  __shared__ double red[Q][NTHR];
  __shared__ bool last;
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < Q; ++q) red[q][t] = v[q];
  __syncthreads();
  for (int s = NTHR / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int q = 0; q < Q; ++q) red[q][t] += red[q][t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) partials[blk * Q + q] = red[q][0];
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned)(nblk - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  double s = 0.0;
  for (int q = t; q < npart; q += NTHR) s += __ldcg(partials + q);
  red[0][t] = s;
  __syncthreads();
  for (int h = NTHR / 2; h > 0; h >>= 1) {
    if (t < h) red[0][t] += red[0][t + h];
    __syncthreads();
  }
  *total = red[0][0];
  if (t == 0) *counter = 0u;
  return true;
}

// The epilogue of a per-call product (B1, B5, E2) on the 64 x BN tile
// (blockIdx.y, c0) of a block of PNT threads: y = s ((A B) o u + acc) for
// the thread's elements, and the per-panel sums of squares of y. Each
// thread sums y^2 per 64 x 32 sub-tile; a sub-tile's partial is a
// butterfly over the warp, then the four warps in order, so the partials
// do not depend on BN; the block that draws the last ticket of *counter
// (left 0) sums each 128-row panel's partials in index order, one warp a
// panel, into ss[panel]. u, y: the call's rows [g.ddp, g.dup].
template <int BN>
__device__ __forceinline__ void matvec_epilogue(const float (&acc)[BN / 2],
                                                const float* da,
                                                const float* db,
                                                const float* u, float* y,
                                                float s, double* partials,
                                                unsigned* counter, float* ss,
                                                const Geo& g, int c0) {
  // this thread's elements: rows ra and ra + 8, column pairs cb + 8 jj
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ra = blockIdx.y * PM + 16 * warp + (lane >> 2);
  const int cb = c0 + 2 * (t & 3);
  float d[BN / 2];
  tile_diag<BN>(d, da, db, g, ra, cb);
  constexpr int Q = BN / 32;
  double part[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) part[q] = 0.0;
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * jj + 2 * h;
      const size_t off = (size_t)(ra + 8 * h) * g.dup + cb + 8 * jj;
      const float2 uc = *reinterpret_cast<const float2*>(u + off);
      float2 yv;
      yv.x = s * fmaf(d[e], uc.x, acc[e]);
      yv.y = s * fmaf(d[e + 1], uc.y, acc[e + 1]);
      part[jj / 4] += (double)yv.x * (double)yv.x
                      + (double)yv.y * (double)yv.y;
      *reinterpret_cast<float2*>(y + off) = yv;
    }
  }
  __shared__ double red[Q][4];
  __shared__ bool last;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    double v = part[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[q][warp] = v;
  }
  __syncthreads();
  const int nsub = g.dup / 32;
  if (t < Q) {
    partials[(size_t)blockIdx.y * nsub + c0 / 32 + t] =
        ((red[t][0] + red[t][1]) + red[t][2]) + red[t][3];
    __threadfence();
  }
  __syncthreads();
  if (t == 0)
    last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // panel p: the 2 nsub partials of its two block rows, summed by warp
  // p % 4 in index order
  const int n = 2 * nsub;
  for (int p = warp; p < g.ddp / 128; p += PNT / 32) {
    double v = 0.0;
    for (int q = lane; q < n; q += 32)
      v += __ldcg(partials + (size_t)p * n + q);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) ss[p] = (float)v;
  }
  if (t == 0) *counter = 0u;
}

constexpr int SPLIT_NT = 256;   // threads of a split block, 8 values each

// parts[p * n + k] = part p of x[k], p < P (split2 or split3: round to
// nearest even)
template <int P>
__global__ void __launch_bounds__(SPLIT_NT)
split_kernel(const float* __restrict__ x, bf16* __restrict__ parts,
             size_t n) {
  const size_t stride = (size_t)gridDim.x * SPLIT_NT * 8;
  for (size_t k = ((size_t)blockIdx.x * SPLIT_NT + threadIdx.x) * 8; k < n;
       k += stride) {
    const float4 a = *reinterpret_cast<const float4*>(x + k);
    const float4 b = *reinterpret_cast<const float4*>(x + k + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint4 pv[P];                // the 8 values' parts
    auto* h = reinterpret_cast<__nv_bfloat162*>(pv);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (P == 2)
        split2(v[2 * q], v[2 * q + 1], h[q], h[4 + q]);
      else
        split3(v[2 * q], v[2 * q + 1], h[q], h[4 + q], h[8 + q]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint4*>(parts + p * n + k) = pv[p];
  }
}

// parts [P, n] bf16 = the P parts of x [n] f32, n a multiple of 8
template <int P>
cudaError_t launch_split(const float* x, bf16* parts, long n,
                         cudaStream_t s) {
  if (n <= 0 || n % 8 != 0) return cudaErrorInvalidValue;
  const long blocks = (n / 8 + SPLIT_NT - 1) / SPLIT_NT;
  split_kernel<P><<<(unsigned)(blocks < 65536 ? blocks : 65536), SPLIT_NT,
                    0, s>>>(x, parts, (size_t)n);
  return cudaGetLastError();
}

// The output tile's width for nb grids of ddp x dup on a card of `sms`
// SMs: the narrowest tile whose blocks are all resident at once, else 64 x
// 128 (bs_chain_tc.cu says why); at P = 3 (B1, B4, B5) 32 or 128 (a ring
// of 64 x 64 holds one block an SM, as 64 x 128 does)
template <int P>
int pick_bn(int ddp, int dup, int nb, int sms) {
  const long rows = (long)(ddp / PM) * nb;
  if (rows * (dup / 32) <= (long)Ring<32, P>::BLOCKS * sms) return 32;
  if (P == 2 && rows * (dup / 64) <= (long)Ring<64, P>::BLOCKS * sms)
    return 64;
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

}  // namespace
