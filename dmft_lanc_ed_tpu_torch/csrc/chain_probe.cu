// The chain probe for Hopper (sm_90a): a K-step normalized power chain in
// ONE thread-block cluster, the whole chain on chip.
//
// Replaces the TPU's Pallas kernel of experiments/chain_probe.py:
//   E1  _kernel  -> chain_probe
// which probes the constructs a one-launch chain needs: on the TPU, A and
// the ping-pong vector planes resident in VMEM over the grid steps, an SMEM
// scalar accumulated over grid steps (|y|^2) and async copies in and out.
// The card's counterpart is a cluster: A resident in each CTA's shared
// memory, the vector in distributed shared memory, a hardware cluster
// barrier between the steps.
//
// What it computes: A [256, 256] f32, v0 [256, 128] f32 (the wrapper pads
// a smaller n with zeros);
//   y_0 = A v0,  y_k = A y_{k-1} / |y_{k-1}|,
//   norms[k] = |y_k|,  vout = y_{K-1}
// with the JAX kernel's Precision.HIGHEST product: Mosaic's six bf16 passes
// over a three-part split (bs_panel_tc.cuh, B4's product), each 64-deep
// stage summed apart and added in FP32; |y|^2 in f64.
//
// What bounds it. A step is 6 x 16.8 MFLOP of bf16 tensor-core products,
// 0.10 us at the H100's 989 TFLOP/s (0.25 us as FP32 at 67 TFLOP/s), over
// 0.4 MB that never leave the chip. One cluster runs on 16 of the 132
// SMs, so whatever the kernel does its share of that bound stays under
// 12 %: at n = 256 the step is set by latency, the product's wgmma
// chain, the epilogue's exchange and the barrier, not by operations or
// bytes. The number this probe gives is the cheapest step a persistent
// chain can take on this card (B2's second launch costs 4.8-6.8 us).
//
// The design:
// - One cluster of 16 CTAs (4 row tiles x 4 column tiles of 64 x 32, a
//   non-portable cluster size; 8 CTAs of 64 x 64, a portable one, made a
//   step 1.8 us longer on an H100); CTA (i, j) owns the 64 x 32 tile
//   (64 i, 32 j) of y, one warpgroup, wgmma m64n32k16 from shared memory.
// - A resident: the CTA's 64 rows of A arrive once a call by one bulk copy
//   (cp.async.bulk behind an mbarrier) into the then unused vector buffers,
//   are split into hi/mid/lo bf16 and stay in shared memory, four 64-deep
//   stages of three parts in the 128-byte swizzle (96 KB), for all K steps.
// - The vector in distributed shared memory: each CTA holds the three parts
//   of its column block of the vector (256 x 32), four stages in the
//   swizzle wgmma's B operand reads (48 KB). Its epilogue scales the
//   tile, splits it into its own buffer's stage i, and one thread sends that stage to the same place of the column block's
//   three other CTAs by bulk copies (cp.async.bulk.shared::cluster.
//   shared::cta), each completing on the receiver's mbarrier, which the
//   receiver waits on before its next product; storing the chunks from
//   every thread (st.shared::cluster) made the step 0.8 us longer. The
//   tile's sum of squares (f64) goes to a slot of every CTA by a remote
//   store. Only norms and the last y reach device memory.
// - One cluster barrier a step (release / acquire): it makes the sums
//   visible, and A (96 KB) and two vector buffers (2 x 48 KB) fit the
//   227 KB a CTA may have, so step k reads buffer k % 2 and writes buffer
//   (k + 1) % 2, which every peer finished reading (and this CTA's copies
//   out of it landed) before step k - 1's barrier. The sum slots are
//   double-buffered by step parity.
// - The same norm everywhere: after the barrier every CTA adds the slots in
//   rank order, so every CTA scales by the same bits; no float atomics,
//   reruns bit-identical.
// - The product: the four stages' six passes issue back to back into four
//   register tiles, one wait, then FP32 adds in stage order (the same sum
//   as panel_stream's per-stage promotion).
// - Every mbarrier wait is bounded: a protocol fault traps, it does not
//   hang the card.
//
// Every entry point returns the CUDA error of its launch (0 = ok).
#include "bs_panel_tc.cuh"

namespace {

constexpr int CP_N = 256;           // A's rows and depth: what one cluster holds
constexpr int CP_COLS = 128;        // vector columns
constexpr int CP_NS = CP_N / PK;    // 64-deep stages of a product
constexpr int CP_RT = CP_N / PM;    // row tiles

// the cluster and shared-memory geometry of the 64 x 32 tile
struct Cl {
  static constexpr int BN = 32;                     // the tile's width
  static constexpr int CT = CP_COLS / BN;           // column tiles
  static constexpr int NC = CP_RT * CT;             // CTAs of the cluster
  static constexpr int B_BYTES = Ring<BN, 3>::B_BYTES;  // a stage's part
  static constexpr int TILE_BYTES = 3 * B_BYTES;    // a stage's three parts
  static constexpr int BUF_BYTES = CP_NS * TILE_BYTES;
  static constexpr int A_RES = CP_NS * 3 * A_BYTES;     // resident A parts
  // two vector buffers; + 1024: the regions start on the swizzle's
  // 1024-byte period
  static constexpr int SMEM = A_RES + 2 * BUF_BYTES + 1024;
  static_assert(2 * BUF_BYTES >= PM * CP_N * 4,
                "A's f32 rows are staged in the vector buffers");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared::cluster address of `addr` (shared::cta) in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// this thread's arrival on `bar`, which then expects `bytes` more
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of `bar` with this parity to complete; a wait that
// never ends (a fault of the protocol) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins > (1l << 24)) __trap();
  }
}

// `bytes` from this CTA's shared memory at src into a peer's at dst
// (shared::cluster), completing on the peer's mbarrier at bar
__device__ __forceinline__ void bulk_s2peer(uint32_t dst, uint32_t src,
                                            uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset, in part 0 of a vector buffer, of element (row, col) of the
// CTA's column block: stage row / 64, deep row % 64, in the swizzle
// load_stage gives B (64-byte rows)
__device__ __forceinline__ uint32_t b_off(int row, int col) {
  const int s = row / PK, k = row % PK, c = col >> 3;
  return s * Cl::TILE_BYTES + k * 64 + ((c ^ ((k >> 1) & 3)) << 4)
         + (col & 7) * 2;
}

__global__ void __launch_bounds__(PNT, 1)
chain_probe_kernel(const float* __restrict__ v0, const float* __restrict__ a,
                   float* __restrict__ norms, float* __restrict__ vout,
                   long long* __restrict__ trace, int kk) {
  using C = Cl;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem[];
  __shared__ double ss[2][C::NC];   // the CTAs' sums of y^2, by step parity
  __shared__ double red[PNT / 32];
  // the bulk copy of A; the tiles of the vector arriving for step k at
  // full[k % 2]
  __shared__ __align__(8) uint64_t mbar, full[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t rank = cluster_rank();
  const int ci = rank / C::CT, cj = rank % C::CT;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t b_res = base + C::A_RES;
  uint8_t* gbuf = gbase + C::A_RES;

  // A's 64 rows, f32, by one bulk copy into the vector buffers
  const uint32_t mb = smem_u32(&mbar);
  if (t == 0) {
    mbar_init(mb);
    mbar_init(smem_u32(&full[0]));
    mbar_init(smem_u32(&full[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    constexpr uint32_t bytes = PM * CP_N * 4;
    mbar_expect(mb, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(b_res), "l"(a + (size_t)ci * PM * CP_N), "r"(bytes), "r"(mb)
        : "memory");
  }
  mbar_wait(mb, 0);
  // ... split into the resident parts: stage d / 64, part p at (3 stage + p)
  // A_BYTES, row r at 128 r in the 128-byte swizzle
  for (int e = t; e < PM * CP_N / 4; e += PNT) {
    const int r = e / (CP_N / 4), d = (e % (CP_N / 4)) * 4;
    const float4 x = reinterpret_cast<const float4*>(gbuf)[e];
    __nv_bfloat162 h0, m0, l0, h1, m1, l1;
    split3(x.x, x.y, h0, m0, l0);
    split3(x.z, x.w, h1, m1, l1);
    const int kd = d % PK;
    uint8_t* dst = gbase + (d / PK) * 3 * A_BYTES + r * 128
                   + (((kd >> 3) ^ (r & 7)) << 4) + (kd & 7) * 2;
    *reinterpret_cast<uint2*>(dst) = make_uint2(bits(h0), bits(h1));
    *reinterpret_cast<uint2*>(dst + A_BYTES) = make_uint2(bits(m0), bits(m1));
    *reinterpret_cast<uint2*>(dst + 2 * A_BYTES) =
        make_uint2(bits(l0), bits(l1));
  }
  __syncthreads();                  // the staged rows are consumed ...
  cluster_arrive();                 // ... so peers may write the buffers
  // v0's column block -> the parts of buffer 0
  for (int e = t; e < CP_N * BN / 4; e += PNT) {
    const int row = e / (BN / 4), col = (e % (BN / 4)) * 4;
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        v0 + (size_t)row * CP_COLS + cj * BN + col));
    __nv_bfloat162 h0, m0, l0, h1, m1, l1;
    split3(x.x, x.y, h0, m0, l0);
    split3(x.z, x.w, h1, m1, l1);
    uint8_t* dst = gbuf + b_off(row, col);
    *reinterpret_cast<uint2*>(dst) = make_uint2(bits(h0), bits(h1));
    *reinterpret_cast<uint2*>(dst + C::B_BYTES) =
        make_uint2(bits(m0), bits(m1));
    *reinterpret_cast<uint2*>(dst + 2 * C::B_BYTES) =
        make_uint2(bits(l0), bits(l1));
  }
  fence_async_smem();
  __syncthreads();

  // this thread's elements of the tile: rows ra and ra + 8, column pairs
  // cb + 8 j (wgmma's accumulator layout)
  const int ra = 16 * warp + (lane >> 2), cb = 2 * (lane & 3);
  float s = 1.f;
  for (int k = 0; k < kk; ++k) {
    const uint32_t bbuf = b_res + (k % 2) * C::BUF_BYTES;
    if (trace != nullptr && t == 0) trace[4 * (k * C::NC + rank)] = clock64();
    // the peers' tiles of y_{k-1} have landed (the phase (k - 1) / 2 of
    // full[k % 2]; step 0 reads v0)
    if (k > 0) mbar_wait(smem_u32(&full[k & 1]), ((k - 1) >> 1) & 1);
    // the zeroed tiles are pinned above the fence (sunk below it, they made
    // ptxas wait for each stage's products before the next stage)
    float part[CP_NS][BN / 2];
#pragma unroll
    for (int st = 0; st < CP_NS; ++st)
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) {
        part[st][q] = 0.f;
        asm volatile("" : "+f"(part[st][q])::"memory");
      }
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < CP_NS; ++st)
      mma_stage_ab<BN, 3>(part[st], base + st * 3 * A_BYTES,
                          bbuf + st * C::TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    if (trace != nullptr && t == 0)
      trace[4 * (k * C::NC + rank) + 1] = clock64();
    float y[BN / 2];
    double sq = 0.0;
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int st = 0; st < CP_NS; ++st) {
        asm volatile("" : "+f"(part[st][q])::"memory");   // after the wait
        acc += part[st][q];
      }
      y[q] = s * acc;
      sq += (double)y[q] * (double)y[q];
    }
    if (k == 0) cluster_wait();     // every peer has split its A
    const bool last = k == kk - 1;
    if (last) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              vout + (size_t)(ci * PM + ra + 8 * h) * CP_COLS + cj * BN + cb
              + 8 * j) = make_float2(y[4 * j + 2 * h], y[4 * j + 2 * h + 1]);
    } else {
      // the tile's parts into stage ci of this CTA's next buffer
      const int nb = (k + 1) % 2;
      const uint32_t bar = smem_u32(&full[(k + 1) & 1]);
      if (t == 0) mbar_expect(bar, (CP_RT - 1) * C::TILE_BYTES);
      uint8_t* dst = gbuf + nb * C::BUF_BYTES;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h;
          __nv_bfloat162 hi, mid, lo;
          split3(y[e], y[e + 1], hi, mid, lo);
          uint8_t* p = dst + b_off(ci * PM + ra + 8 * h, cb + 8 * j);
          *reinterpret_cast<__nv_bfloat162*>(p) = hi;
          *reinterpret_cast<__nv_bfloat162*>(p + C::B_BYTES) = mid;
          *reinterpret_cast<__nv_bfloat162*>(p + 2 * C::B_BYTES) = lo;
        }
      fence_async_smem();         // ... seen by the bulk copies' reads
      __syncthreads();
      // ... and by bulk copies into the same place of the column block's
      // other CTAs, each completing on that CTA's full[(k + 1) % 2]
      if (t == 0) {
        const uint32_t src = b_res + nb * C::BUF_BYTES + ci * C::TILE_BYTES;
#pragma unroll
        for (int q = 1; q < CP_RT; ++q) {
          const uint32_t peer = ((ci + q) % CP_RT) * C::CT + cj;
          bulk_s2peer(peer_addr(src, peer), src, C::TILE_BYTES,
                      peer_addr(bar, peer));
        }
      }
    }
    // the tile's sum of squares: lanes, then warps in order, into slot
    // `rank` of every CTA
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (lane == 0) red[warp] = sq;
    __syncthreads();
    if (t < C::NC)
      st_peer(peer_addr(smem_u32(&ss[k & 1][rank]), t),
              ((red[0] + red[1]) + red[2]) + red[3]);
    if (trace != nullptr && t == 0)
      trace[4 * (k * C::NC + rank) + 2] = clock64();
    cluster_sync();
    if (trace != nullptr && t == 0)
      trace[4 * (k * C::NC + rank) + 3] = clock64();
    // every CTA adds the slots in rank order: the same norm everywhere
    double tot = 0.0;
#pragma unroll
    for (int q = 0; q < C::NC; ++q) tot += ss[k & 1][q];
    const float nrm = (float)sqrt(tot);
    if (rank == 0 && t == 0) norms[k] = nrm;
    s = 1.f / nrm;
  }
}

// the launch of one cluster of Cl::NC CTAs (cfg.attrs -> *attr)
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  using C = Cl;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::NC);
  cfg.blockDim = dim3(PNT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's attributes set on this device (once), and *clusters = the
// clusters the card can hold at once
cudaError_t prepare(int* clusters) {
  using C = Cl;
  static int held[64];
  static bool asked[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!asked[dev]) {
    auto* kern = chain_probe_kernel;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err == cudaSuccess)         // 16 CTAs: past the portable 8
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, nullptr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&held[dev], kern, &cfg);
    if (err != cudaSuccess) return err;
    asked[dev] = true;
  }
  *clusters = held[dev];
  return cudaSuccess;
}

cudaError_t launch(const float* v0, const float* a, float* norms,
                   float* vout, long long* trace, int kk,
                   cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = prepare(&clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorNotSupported;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, stream);
  err = cudaLaunchKernelEx(&cfg, chain_probe_kernel, v0, a, norms, vout,
                           trace, kk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// out[0..4] = CTAs of the cluster, dynamic and static shared memory bytes
// a CTA, registers a thread, clusters the card holds at once
cudaError_t geometry(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = prepare(&out[4]);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, chain_probe_kernel);
  if (err != cudaSuccess) return err;
  out[0] = Cl::NC;
  out[1] = Cl::SMEM;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = fa.numRegs;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K = kk chain steps in one cluster launch: v0 [256, 128], a [256, 256],
// norms [kk], vout [256, 128] f32, v0 and a 16-byte aligned. trace: null,
// or [kk, 16, 4] int64 that gets each CTA's SM clock (clock64) a step at
// its start, after the product, before the step's cluster barrier and
// after it.
// Returns cudaErrorNotSupported if the card cannot schedule the cluster
// (cudaOccupancyMaxActiveClusters is 0).
int chain_probe(const void* v0, const void* a, void* norms, void* vout,
                void* trace, int kk, void* stream) {
  // the bulk copy of A and v0's float4 loads need 16-byte alignment
  if (kk <= 0 || ((size_t)v0 | (size_t)a) % 16)
    return (int)cudaErrorInvalidValue;
  const float* pv0 = static_cast<const float*>(v0);
  const float* pa = static_cast<const float*>(a);
  float* pn = static_cast<float*>(norms);
  float* pout = static_cast<float*>(vout);
  long long* ptr = static_cast<long long*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch(pv0, pa, pn, pout, ptr, kk, s);
}

// out [5] int32: the cluster and its CTAs (geometry above)
int chain_probe_geometry(void* out) {
  return (int)geometry(static_cast<int*>(out));
}

}  // extern "C"
