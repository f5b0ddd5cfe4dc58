// The split-bf16 band-sparse panel product on the tensor cores (sm_90a),
// shared by the experiment-probe kernels trim_ab.cu (E2) and
// chain_breakdown.cu (E3).
//
// The JAX package reaches f32 accuracy on the TPU's matrix unit with a
// three-pass product of bf16 parts (dmft_lanc_ed_tpu/ops/blocksparse.py
// _dot3): x ~ x_hi + x_lo with x_hi = bf16(x), x_lo = bf16(x - x_hi), and
//   x a ~ x_hi a_hi + x_lo a_hi + x_hi a_lo        (f32 accumulation).
// Here each pass is a 16 x 16 x 16 WMMA bf16 product with f32 accumulation
// (the tensor cores; products of bf16 values are exact in f32). PASSES = 1
// keeps only x_hi a_hi (the probes' "1pass" form).
//
// The panel math is that of bs_panel.cuh, on the RCM-permuted vector u
// padded to multiples of 128, u[ddp, dup]:
//   H u = (A B) o u + H_dw,p u + u H_up,p
// with the dw slabs [ntd, 128, W_dw] and the up slabs [ntu, W_up, 128],
// here as pre-split bf16 hi/lo pairs, and the window clamps of the JAX
// package (blocksparse.py:579, :597). A block of TC_NT = 128 threads (4
// warps, each a 32 x 32 quarter of 2 x 2 fragments) computes one 64 x 64
// output tile. The contraction runs over a LIST of 128-tiles of the window
// (indices relative to the clamped window start, ascending), which each
// probe fills from its own table (per-tile lists, runs or masks): a tile
// left out of the list adds exactly zero if its slab tile is zero, so every
// list that holds the nonzero tiles in ascending order gives the same bits.
//
// A 64-deep stage of the contraction sits in shared memory as bf16 hi/lo
// pairs. The slab side arrives pre-split; the vector side is read as f32
// and split while it is staged (stage_plane), as the TPU kernels split
// each window read, or read as stored bf16 pairs (stage_plane<true>, the
// E3 "bf16pair" form). WMMA wants 256-bit aligned fragment pointers and
// a leading dimension that is a multiple of 8 bf16 (4 floats): every row
// below is padded by 8 (4) elements and every fragment starts on a
// 16-row, 16-column boundary of a 128-byte aligned buffer.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "bs_panel.cuh"   // Geo, geo_ok, dw_window_base, diag4, FIN_NT,
                          // fixed_order_sum

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;          // output rows per block
constexpr int TN = 64;          // output columns per block
constexpr int TK = 64;          // contraction depth per shared-memory stage
constexpr int TC_NT = 128;      // threads per block: 4 warps
constexpr int LDS = 64 + 8;     // bf16 row pitch of a staged operand
constexpr int LDC = TN + 4;     // float row pitch of the output staging
constexpr int MAX_WT = 256;     // longest window, in 128-tiles

// geo_ok, and windows the tile lists can hold
inline bool tc_geo_ok(const Geo& g) {
  return geo_ok(g) && g.w_dw / 128 <= MAX_WT && g.w_up / 128 <= MAX_WT;
}

// one staged 64-deep step of the product, as bf16 hi/lo pairs
struct Stage {
  bf16 a_hi[TM][LDS], a_lo[TM][LDS];        // rows x depth
  bf16 b_hi[TK][LDS], b_lo[TK][LDS];        // depth x columns
};

// the shared memory of one tile block
struct __align__(128) TileSmem {
  union {
    Stage st;
    float c[TM][LDC];                       // the finished products
  } u;
  int dw_t[MAX_WT], up_t[MAX_WT];           // window tiles to walk
  int n_dw, n_up;
  double red[TC_NT];
};

// the vector side of the product: an f32 plane (split while staged) or a
// bf16 hi/lo pair of planes
struct Plane {
  const float* f;
  const bf16* hi;
  const bf16* lo;
};

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  __nv_bfloat162 v = __halves2bfloat162(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x -> (bf16(x), bf16(x - bf16(x))), round to nearest even, as the JAX
// package's split (blocksparse.py:130) and torch's .to(torch.bfloat16)
__device__ __forceinline__ void split1(float x, bf16& h, bf16& l) {
  h = __float2bfloat16_rn(x);
  l = __float2bfloat16_rn(x - __bfloat162float(h));
}

__device__ __forceinline__ void split4(float4 x, uint2& hi, uint2& lo) {
  bf16 h0, h1, h2, h3, l0, l1, l2, l3;
  split1(x.x, h0, l0);
  split1(x.y, h1, l1);
  split1(x.z, h2, l2);
  split1(x.w, h3, l3);
  hi = make_uint2(pack2(h0, h1), pack2(h2, h3));
  lo = make_uint2(pack2(l0, l1), pack2(l2, l3));
}

// stage a 64 x 64 block of a row-major matrix (leading dimension ld) into
// dst_hi/dst_lo [64][LDS]: from an f32 plane, split on the way
template <bool PAIR>
__device__ __forceinline__ void stage_plane(bf16 (*dst_hi)[LDS],
                                            bf16 (*dst_lo)[LDS],
                                            const Plane& p, size_t off,
                                            int ld, bool need_lo) {
  const int t = threadIdx.x;
  if (!PAIR) {
#pragma unroll
    for (int it = 0; it < 8; ++it) {          // 64 x 16 float4
      const int idx = it * TC_NT + t;
      const int r = idx / 16, c = (idx % 16) * 4;
      const float4 x = *reinterpret_cast<const float4*>(
          p.f + off + (size_t)r * ld + c);
      uint2 hi, lo;
      split4(x, hi, lo);
      *reinterpret_cast<uint2*>(&dst_hi[r][c]) = hi;
      if (need_lo) *reinterpret_cast<uint2*>(&dst_lo[r][c]) = lo;
    }
  } else {
#pragma unroll
    for (int it = 0; it < 4; ++it) {          // 64 x 8 uint4 (8 bf16 each)
      const int idx = it * TC_NT + t;
      const int r = idx / 8, c = (idx % 8) * 8;
      const size_t g = off + (size_t)r * ld + c;
      *reinterpret_cast<uint4*>(&dst_hi[r][c]) =
          *reinterpret_cast<const uint4*>(p.hi + g);
      if (need_lo)
        *reinterpret_cast<uint4*>(&dst_lo[r][c]) =
            *reinterpret_cast<const uint4*>(p.lo + g);
    }
  }
}

// stage a 64 x 64 block of a pre-split bf16 slab (leading dimension ld)
__device__ __forceinline__ void stage_slab(bf16 (*dst_hi)[LDS],
                                           bf16 (*dst_lo)[LDS],
                                           const bf16* __restrict__ hi,
                                           const bf16* __restrict__ lo,
                                           size_t off, int ld, bool need_lo) {
  const int t = threadIdx.x;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * TC_NT + t;
    const int r = idx / 8, c = (idx % 8) * 8;
    const size_t g = off + (size_t)r * ld + c;
    *reinterpret_cast<uint4*>(&dst_hi[r][c]) =
        *reinterpret_cast<const uint4*>(hi + g);
    if (need_lo)
      *reinterpret_cast<uint4*>(&dst_lo[r][c]) =
          *reinterpret_cast<const uint4*>(lo + g);
  }
}

using namespace nvcuda;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += the staged a [64 x 64] x b [64 x 64], warp quarter (wr, wc): per
// 16-deep step hi.hi, then lo.hi, then hi.lo (PASSES = 3) or hi.hi alone
template <int PASSES>
__device__ __forceinline__ void mma_stage(AccFrag (&acc)[2][2],
                                          const TileSmem& sm, int wr,
                                          int wc) {
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  const Stage& st = sm.u.st;
#pragma unroll
  for (int k = 0; k < TK; k += 16) {
    FragA ah[2], al[2];
    FragB bh[2], bl[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      wmma::load_matrix_sync(ah[m], &st.a_hi[wr * 32 + m * 16][k], LDS);
      if (PASSES == 3)
        wmma::load_matrix_sync(al[m], &st.a_lo[wr * 32 + m * 16][k], LDS);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      wmma::load_matrix_sync(bh[n], &st.b_hi[k][wc * 32 + n * 16], LDS);
      if (PASSES == 3)
        wmma::load_matrix_sync(bl[n], &st.b_lo[k][wc * 32 + n * 16], LDS);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::mma_sync(acc[m][n], ah[m], bh[n], acc[m][n]);
        if (PASSES == 3) {
          wmma::mma_sync(acc[m][n], al[m], bh[n], acc[m][n]);
          wmma::mma_sync(acc[m][n], ah[m], bl[n], acc[m][n]);
        }
      }
  }
}

// The hop products of the 64 x 64 output tile (r0, c0), without the
// diagonal, left in sm.u.c[64][LDC] (f32): the dw slab rows r0.. of panel
// r0/128 times the window rows of u, over the window tiles sm.dw_t, then
// u's rows r0.. over the lane window tiles sm.up_t times the columns c0..
// of up slab c0/128. The caller fills sm.dw_t/up_t/n_dw/n_up and
// synchronizes first.
template <int PASSES, bool PAIR>
__device__ void hop_tile_tc(TileSmem& sm, const bf16* __restrict__ dw_hi,
                            const bf16* __restrict__ dw_lo,
                            const bf16* __restrict__ up_hi,
                            const bf16* __restrict__ up_lo, const Plane& u,
                            const Geo& g, int r0, int c0) {
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;
  const bool lo = PASSES == 3;
  AccFrag acc[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  const int i = r0 / 128, j = c0 / 128;
  const int base = dw_window_base(g, i);
  const int s_up = min(max((j - g.d_up) * 128, 0), g.dup - g.w_up);
  const size_t dw_row = ((size_t)i * 128 + (r0 % 128)) * g.w_dw;
  for (int q = 0; q < sm.n_dw; ++q) {
    for (int h = 0; h < 128; h += TK) {
      const int k0 = sm.dw_t[q] * 128 + h;
      __syncthreads();                      // the last stage is consumed
      stage_slab(sm.u.st.a_hi, sm.u.st.a_lo, dw_hi, dw_lo, dw_row + k0,
                 g.w_dw, lo);
      stage_plane<PAIR>(sm.u.st.b_hi, sm.u.st.b_lo, u,
                        (size_t)(base + k0) * g.dup + c0, g.dup, lo);
      __syncthreads();
      mma_stage<PASSES>(acc, sm, wr, wc);
    }
  }
  const size_t up_col = (size_t)j * g.w_up * 128 + (c0 % 128);
  for (int q = 0; q < sm.n_up; ++q) {
    for (int h = 0; h < 128; h += TK) {
      const int k0 = sm.up_t[q] * 128 + h;
      __syncthreads();
      stage_plane<PAIR>(sm.u.st.a_hi, sm.u.st.a_lo, u,
                        (size_t)r0 * g.dup + s_up + k0, g.dup, lo);
      stage_slab(sm.u.st.b_hi, sm.u.st.b_lo, up_hi, up_lo,
                 up_col + (size_t)k0 * 128, 128, lo);
      __syncthreads();
      mma_stage<PASSES>(acc, sm, wr, wc);
    }
  }
  __syncthreads();                          // sm.u.c overlays the stages
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      wmma::store_matrix_sync(&sm.u.c[wr * 32 + m * 16][wc * 32 + n * 16],
                              acc[m][n], LDC, wmma::mem_row_major);
  __syncthreads();
}

// block sum of one double per thread (TC_NT threads), in a fixed order
__device__ __forceinline__ double tile_block_sum(TileSmem& sm, double v) {
  sm.red[threadIdx.x] = v;
  __syncthreads();
  for (int s = TC_NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm.red[threadIdx.x] += sm.red[threadIdx.x + s];
    __syncthreads();
  }
  return sm.red[0];
}

}  // namespace
