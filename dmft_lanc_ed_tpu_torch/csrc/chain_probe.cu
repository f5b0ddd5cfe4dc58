// The chain probe for Hopper (sm_90a): a K-step normalized power chain in
// ONE cooperative launch, FP32 FMA.
//
// Replaces the TPU's Pallas kernel of experiments/chain_probe.py:
//   E1  _kernel  -> chain_probe
// which probes the constructs a one-launch chain needs: on the TPU, VMEM
// scratch persisting over grid steps (the ping-pong planes), an SMEM scalar
// accumulated over grid steps (|y|^2) and async copies in and out. Here:
// one cooperatively launched grid (cudaLaunchCooperativeKernel, all blocks
// co-resident) runs all K steps with cooperative_groups grid syncs between
// them; the two planes ping-pong in device memory; each block owns one
// 32 x 32 tile of the product and keeps its 32 rows of A in shared memory
// over the steps; |y|^2 is summed in a fixed order (each block its tile,
// then every block adds the block sums in the same order after the sync,
// so every block holds the same norm; no float atomics).
//
// What it computes: A [n, n] f32, v0 [n, 128] f32;
//   y_0 = A v0,  y_k = A y_{k-1} / |y_{k-1}|,
//   norms[k] = |y_k|,  vout = y_{K-1}
// (products in f32, as the JAX kernel's Precision.HIGHEST).
//
// What bounds it. At the probe's n = 256 a step is 2 * 256 * 256 * 128 =
// 16.8 MFLOP, 0.25 us at the 67 TFLOP/s FP32 peak, on 32 blocks of the 132
// SMs: the grid sync between the steps sets the time, and that cost is the
// number this probe gives beside B2's four launches per step.
//
// Every entry point returns the CUDA error of its launch (0 = ok).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PB = 32;          // tile rows and columns per block
constexpr int PK = 64;          // vector rows per shared-memory stage
constexpr int NMAX = 256;       // widest A held in shared memory
constexpr int PNT = 256;        // threads per block: 32 rows x 8 quads
constexpr int PCOLS = 128;      // vector columns

// fixed-order sum over a warp (lane 0 gets it)
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(PNT)
chain_probe_kernel(const float* __restrict__ v0, const float* __restrict__ a,
                   float* __restrict__ norms, float* vout, float* buf,
                   double* partials, int n, int kk) {
  // the block's 32 rows of A stay resident over the steps (the TPU kernel
  // keeps A in VMEM); the vector streams through 64-row stages
  __shared__ float as[PB][NMAX + 1];
  __shared__ __align__(16) float bs[PK][PB];
  __shared__ double red[PNT / 32];
  __shared__ float inv_s;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int ty = t / 8, tx = (t % 8) * 4;
  const int r0 = blockIdx.y * PB, c0 = blockIdx.x * PB;
  const int nblk = gridDim.x * gridDim.y;
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = (size_t)n * PCOLS;
  for (int e = t; e < PB * n; e += PNT)
    as[e / n][e % n] = a[(size_t)(r0 + e / n) * n + e % n];
  float s = 1.f;
  for (int k = 0; k < kk; ++k) {
    // step k reads plane k % 2 (v0 at step 0) and writes the other plane
    // (vout at the last step)
    const float* u = k == 0 ? v0 : buf + (size_t)(k % 2) * plane;
    float* y = k == kk - 1 ? vout : buf + (size_t)(1 - k % 2) * plane;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += PK) {
      __syncthreads();                        // the last stage is consumed
      const int kq = min(PK, n - k0);
      for (int e = t; e < kq * PB / 4; e += PNT) {
        const int r = e / (PB / 4), c = (e % (PB / 4)) * 4;
        // written by other blocks in this launch: read past the L1
        *reinterpret_cast<float4*>(&bs[r][c]) = __ldcg(
            reinterpret_cast<const float4*>(u + (size_t)(k0 + r) * PCOLS
                                            + c0 + c));
      }
      __syncthreads();
      for (int q = 0; q < kq; ++q) {
        const float av = as[ty][k0 + q];
        const float4 bv = *reinterpret_cast<const float4*>(&bs[q][tx]);
        acc[0] = fmaf(av, bv.x, acc[0]);
        acc[1] = fmaf(av, bv.y, acc[1]);
        acc[2] = fmaf(av, bv.z, acc[2]);
        acc[3] = fmaf(av, bv.w, acc[3]);
      }
    }
    float4 yv;
    yv.x = s * acc[0];
    yv.y = s * acc[1];
    yv.z = s * acc[2];
    yv.w = s * acc[3];
    *reinterpret_cast<float4*>(y + (size_t)(r0 + ty) * PCOLS + c0 + tx) = yv;
    // |y|^2 of the tile in a fixed order: lanes, then warps
    const double part = warp_sum((double)yv.x * yv.x + (double)yv.y * yv.y
                                 + (double)yv.z * yv.z + (double)yv.w * yv.w);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    // the block sums of step k go to half k % 2 of partials: a block still
    // reading step k's sums never sees step k + 1's writes
    double* pk = partials + (size_t)(k % 2) * nblk;
    if (t == 0) {
      double tile = 0.0;
      for (int w = 0; w < PNT / 32; ++w) tile += red[w];
      pk[b] = tile;
    }
    grid.sync();
    // every block adds the block sums in the same fixed order
    if (warp == 0) {
      double tot = 0.0;
      for (int q = lane; q < nblk; q += 32) tot += __ldcg(pk + q);
      tot = warp_sum(tot);
      if (lane == 0) {
        const float nrm = (float)sqrt(tot);
        if (b == 0) norms[k] = nrm;
        inv_s = 1.f / nrm;
      }
    }
    __syncthreads();
    s = inv_s;
  }
}

}  // namespace

extern "C" {

// K = kk chain steps in one cooperative launch. v0 [n, 128], a [n, n],
// norms [kk], vout [n, 128] f32; buf [2, n, 128] f32 and partials
// [2 * (n / 32) * 4] f64 scratch. n a multiple of 32, at most 256. Fails
// with cudaErrorCooperativeLaunchTooLarge if the grid cannot be
// co-resident.
int chain_probe(const void* v0, const void* a, void* norms, void* vout,
                void* buf, void* partials, int n, int kk, void* stream) {
  if (n <= 0 || n % PB != 0 || n > NMAX || kk <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_probe_kernel, PNT, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const dim3 grid(PCOLS / PB, n / PB);
  if ((long)per_sm * nsm < (long)grid.x * grid.y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* pv0 = static_cast<const float*>(v0);
  const float* pa = static_cast<const float*>(a);
  float* pn = static_cast<float*>(norms);
  float* pout = static_cast<float*>(vout);
  float* pbuf = static_cast<float*>(buf);
  double* ppart = static_cast<double*>(partials);
  void* args[] = {&pv0, &pa, &pn, &pout, &pbuf, &ppart, &n, &kk};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chain_probe_kernel), grid, dim3(PNT), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
