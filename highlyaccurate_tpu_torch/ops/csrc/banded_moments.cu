// K1: fused LM moments of bilinear line samples (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel family behind make_banded_moments
// (highlyaccurate_tpu/ops/pallas/banded_warp.py:704; bodies
// _kernel_moments_fullmap_blocked_uwin :649, _kernel_moments_fullmap_blocked
// :359, _kernel_moments_fullmap :339, _kernel_moments :315).  Those are TPU
// schedules of one contract; this file ports the contract, not the schedule:
// no integer shear, no banded matmuls, no column blocks or u-windows.
//
// Contract, for each (batch b, ground row v) and sample u in [0, W):
//   x = ax + bx*u, y = ay + by*u         (row coefficients from
//                                         pack_row_coefs; ax = 1e9 marks a
//                                         row the validity guard zeroed)
//   keep = 0 <= x,y <= A-1 and floor(x) < A-1 and floor(y) < A-1
//          (the reference edge quirk: a sample on the last row or column
//          is dropped)
//   s, ds/dx, ds/dy = bilinear value and screen derivatives of the map
//          sat[b, y, x, :] (kernel axes; map in bf16 or fp32, math in fp32)
//   nine channel dots with the target row g = grd[b, v, u, :]:
//     ss, gg, sxx, sxy, syy, dxs, dys, dxg, dyg   (MOM_IDX lane order)
//   each times the ray mask mask[v, u], summed over u with weights 1, u, u^2
//   -> out[b, v, 3, 16], lanes 9..15 zero.  gg is summed for every sample
//   with a nonzero mask, kept or not.
//
// What bounds it on the H100: bytes.  Per image and round the fp32 target
// rows are 2.1 / 4.2 / 8.4 MB at the flagship slots 0 / 1 / 2 and the bf16
// map at most as much again, against ~42 flop per (sample, channel): about
// 5 flop/byte, far below the card's ridge.  The kernel reads every target
// element of a live sample once and each map corner from L1/L2 directly
// (the corners of neighbouring samples overlap), keeps all intermediate
// values in registers and writes 192 bytes per row.
//
// Design.
// * Rows split across a cluster.  The S blocks of one (b, v) row form a
//   thread-block cluster; rank r takes the contiguous samples
//   [r*W/S, (r+1)*W/S).  S = min(8, ceil(1024 / (B*V)), W): 8 / 4 / 2 at
//   the flagship slots 0 / 1 / 2 (B*V = 128 / 256 / 512), 1,024 blocks of
//   256 threads at every slot, several waves on 132 SMs where one block per
//   row gave 128 / 256 / 512.  A W that is not a multiple of S, or shorter
//   than one block's share of samples, leaves some groups or ranks idle.
// * Lane groups per sample.  G = 32 / 16 / 8 lanes share one sample (G =
//   C/8 clamped to [8, 32]: 32 / 16 / 8 at C = 256 / 128 / 64), so each lane
//   holds 4 channel pairs of it and a warp holds 1 / 2 / 4 samples at once.
//   The per-sample bookkeeping (coordinates, 27 u-weighted sums) is paid by
//   G lanes, not 32: at C = 64 it was most of the old kernel's instructions.
// * Loads in flight.  A lane issues all 4 x 5 loads of its channel pairs
//   (four map corners as __nv_bfloat162 or float2, the target as float2;
//   pairs past C load zeros, which add exactly 0) before using any, and the
//   groups of a warp do so for 1-4 samples.  keep is uniform in a group, so
//   the loads are not behind a divergent branch.
// * Masked samples.  A sample with mask 0 contributes exactly 0 to every
//   lane for finite inputs (the plain version multiplies its dots by the
//   mask), so it is skipped and its target row never read.
// * Deterministic reduction, one launch.  Each lane keeps the 27 sums of its
//   samples in registers; a warp-shuffle tree, the 8 warps in order in
//   shared memory, then rank 0 reads the S blocks' 27 partials through
//   distributed shared memory (cooperative_groups::this_cluster(),
//   map_shared_rank) in rank order and writes [3, 16].  Every sum runs in
//   a fixed order, so two launches on the same inputs give the same bits;
//   there is no temporary buffer in HBM and no second kernel.
// * Coordinates.  Explicit round-to-nearest multiply and add (no FMA
//   contraction), the two roundings the plain PyTorch version performs, so
//   both pick the same bilinear cell.  The bilinear value and derivatives
//   take 8 operations per channel (accumulate_channel).
// * Residency.  The 27 sums and 20 loads in flight want ~80 registers: 3
//   blocks per SM.  __launch_bounds__ caps them at 64 (4 blocks per SM, 32
//   warps), at the price of ~100 bytes of spill per thread, which ran
//   faster at every slot on the card; 48 registers (5 blocks) ran slower.
//
// TMA (cp.async.bulk) staging of the target segment is not used: each
// group's target loads are already 64-256 contiguous bytes issued together
// with the corner loads, and the kernel is bound by resident warps, not by
// bytes in flight.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMoments = 9;
constexpr int kAcc = 3 * kMoments;
constexpr int kLanesOut = 16;
constexpr int kCoefs = 8;
constexpr int kPairsPerLane = 4;   // channel pairs a lane loads at once
constexpr int kMaxSplit = 8;       // blocks per row: the portable cluster
constexpr int kTargetBlocks = 1024;
constexpr int kBlocksPerSM = 4;    // caps registers at 64 per thread

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One channel's bilinear value and derivatives, accumulated into the nine
// per-sample channel dots p[].  With top = a + fx (b - a) and bot = c +
// fx (d - c): s = top + fy (bot - top), dx = (b - a) + fy ((d - c) - (b - a)),
// dy = bot - top, the plain version's sums in 8 operations.
__device__ __forceinline__ void accumulate_channel(
    float a, float b, float c, float d, float g, float fx, float fy,
    float* p) {
  const float e1 = b - a, e2 = d - c;
  const float top = fmaf(fx, e1, a), bot = fmaf(fx, e2, c);
  const float dy = bot - top;
  const float s = fmaf(fy, dy, top);
  const float dx = fmaf(fy, e2 - e1, e1);
  p[0] += s * s;
  p[1] += g * g;
  p[2] += dx * dx;
  p[3] += dx * dy;
  p[4] += dy * dy;
  p[5] += dx * s;
  p[6] += dy * s;
  p[7] += dx * g;
  p[8] += dy * g;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
banded_moments_kernel(const float* __restrict__ coefs,
                      const T* __restrict__ sat,
                      const float* __restrict__ grd,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int V, int W, int A, int C,
                      int S, long long sat_sb, long long sat_sy,
                      long long sat_sx, long long grd_sb) {
  constexpr int kGroups = kThreads / G;
  const int row = blockIdx.x / S;  // b * V + v; the cluster of this row
  const int rank = blockIdx.x - row * S;
  const int b = row / V;
  const int v = row - b * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = threadIdx.x % G;  // lane within the sample's group
  const int group = threadIdx.x / G;

  const float* cf = coefs + static_cast<long long>(row) * kCoefs;
  const float ax = cf[0], bx = cf[1], ay = cf[2], by = cf[3];
  const T* map = sat + b * sat_sb;
  const float* g_row = grd + b * grd_sb + static_cast<long long>(v) * W * C;
  const float* m_row = mask + static_cast<long long>(v) * W;
  const float lim = static_cast<float>(A - 1);
  const int C2 = C >> 1;
  const int u_end = static_cast<int>(static_cast<long long>(rank + 1) * W / S);

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;

  for (int u = static_cast<int>(static_cast<long long>(rank) * W / S) + group;
       u < u_end; u += kGroups) {
    const float w0 = m_row[u];
    if (w0 == 0.f) continue;  // adds exactly 0 for finite inputs
    const float uf = static_cast<float>(u);
    const float x = __fadd_rn(ax, __fmul_rn(bx, uf));
    const float y = __fadd_rn(ay, __fmul_rn(by, uf));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const bool keep = x >= 0.f && x <= lim && y >= 0.f && y <= lim &&
                      x0f < lim && y0f < lim;  // uniform in the group
    // a dropped sample reads no map: its corners load as zeros, so only its
    // gg dot is nonzero (finite weights keep 0 * weight exact)
    const float fx = keep ? x - x0f : 0.f;
    const float fy = keep ? y - y0f : 0.f;
    const long long off = keep ? static_cast<long long>(y0f) * sat_sy +
                                     static_cast<long long>(x0f) * sat_sx
                               : 0;
    const T* p00 = map + off;
    const float* g_px = g_row + static_cast<long long>(u) * C;

    float p[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) p[k] = 0.f;
    for (int c0 = gl; c0 < C2; c0 += G * kPairsPerLane) {
      float2 g[kPairsPerLane], a[kPairsPerLane], bb[kPairsPerLane],
          cc[kPairsPerLane], d[kPairsPerLane];
#pragma unroll
      for (int k = 0; k < kPairsPerLane; ++k) {
        const int c = 2 * (c0 + k * G);
        const bool in = c < C;
        const bool in_map = in && keep;
        const float2 z = make_float2(0.f, 0.f);
        g[k] = in ? load_pair(g_px + c) : z;
        a[k] = in_map ? load_pair(p00 + c) : z;
        bb[k] = in_map ? load_pair(p00 + sat_sx + c) : z;
        cc[k] = in_map ? load_pair(p00 + sat_sy + c) : z;
        d[k] = in_map ? load_pair(p00 + sat_sy + sat_sx + c) : z;
      }
#pragma unroll
      for (int k = 0; k < kPairsPerLane; ++k) {
        accumulate_channel(a[k].x, bb[k].x, cc[k].x, d[k].x, g[k].x, fx, fy,
                           p);
        accumulate_channel(a[k].y, bb[k].y, cc[k].y, d[k].y, g[k].y, fx, fy,
                           p);
      }
    }
    const float w1 = uf;
    const float w2 = uf * uf;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
      const float q = p[k] * w0;
      acc[k] += q;
      acc[kMoments + k] += q * w1;
      acc[2 * kMoments + k] += q * w2;
    }
  }

  // the warp's lanes (all its groups), then the warps in order, then the
  // cluster's ranks in order: a fixed order, so the result is repeatable
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    acc[k] = s;
  }
  __shared__ float part[kWarps][kAcc];
  __shared__ float block_sum[kAcc];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    block_sum[threadIdx.x] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0 && threadIdx.x < 3 * kLanesOut) {
    const int r = threadIdx.x / kLanesOut;  // 0: sum, 1: u-sum, 2: u^2-sum
    const int l = threadIdx.x - r * kLanesOut;
    float s = 0.f;
    if (l < kMoments) {
      for (int q = 0; q < S; ++q)
        s += cluster.map_shared_rank(block_sum, q)[r * kMoments + l];
    }
    out[static_cast<long long>(row) * 3 * kLanesOut + threadIdx.x] = s;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

template <typename T, int G>
cudaError_t launch(int S, const float* coefs, const T* sat, const float* grd,
                   const float* mask, float* out, int B, int V, int W, int A,
                   int C, long long sat_sb, long long sat_sy,
                   long long sat_sx, long long grd_sb, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(V) *
                     static_cast<unsigned>(S));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, banded_moments_kernel<T, G>, coefs, sat,
                            grd, mask, out, V, W, A, C, S, sat_sb, sat_sy,
                            sat_sx, grd_sb);
}

template <typename T>
cudaError_t launch_group(int S, const float* coefs, const T* sat,
                         const float* grd, const float* mask, float* out,
                         int B, int V, int W, int A, int C, long long sat_sb,
                         long long sat_sy, long long sat_sx, long long grd_sb,
                         cudaStream_t stream) {
  const int pairs = C / 2;
  if (pairs >= 32 * kPairsPerLane)
    return launch<T, 32>(S, coefs, sat, grd, mask, out, B, V, W, A, C,
                         sat_sb, sat_sy, sat_sx, grd_sb, stream);
  if (pairs >= 16 * kPairsPerLane)
    return launch<T, 16>(S, coefs, sat, grd, mask, out, B, V, W, A, C,
                         sat_sb, sat_sy, sat_sx, grd_sb, stream);
  return launch<T, 8>(S, coefs, sat, grd, mask, out, B, V, W, A, C, sat_sb,
                      sat_sy, sat_sx, grd_sb, stream);
}

// Blocks per row (the cluster size) for B*V rows of W samples.
int split_rows(int B, int V, int W) {
  const long long rows = static_cast<long long>(B) * V;
  long long s = (kTargetBlocks + rows - 1) / rows;
  s = s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
  return static_cast<int>(s < W ? s : W);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers;
// strides are in elements.  Launches on `stream` and returns the CUDA error
// of the launch (0 on success); never synchronises.
extern "C" int banded_moments_launch(const void* coefs, const void* sat,
                                     const void* grd, const void* mask,
                                     void* out, int B, int V, int W, int A,
                                     int C, long long sat_sb,
                                     long long sat_sy, long long sat_sx,
                                     long long grd_sb, int bf16_map,
                                     void* stream) {
  const int S = split_rows(B, V, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_map) {
    err = launch_group(S, static_cast<const float*>(coefs),
                       static_cast<const __nv_bfloat16*>(sat),
                       static_cast<const float*>(grd),
                       static_cast<const float*>(mask),
                       static_cast<float*>(out), B, V, W, A, C, sat_sb,
                       sat_sy, sat_sx, grd_sb, s);
  } else {
    err = launch_group(S, static_cast<const float*>(coefs),
                       static_cast<const float*>(sat),
                       static_cast<const float*>(grd),
                       static_cast<const float*>(mask),
                       static_cast<float*>(out), B, V, W, A, C, sat_sb,
                       sat_sy, sat_sx, grd_sb, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
